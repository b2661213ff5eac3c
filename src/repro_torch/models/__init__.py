"""Model of the port: config, layers, KV and Mamba state, the block stack."""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig
from repro_torch.models.model import (ModelParams, decode_step,
                                      init_decode_state, init_params,
                                      params_from_numpy, prefill,
                                      prefill_bucketed)
from repro_torch.models.transformer import HostIO, QKVOut, check_supported

__all__ = [
    "BlockKind", "FFNKind", "ModelConfig", "ModelParams", "decode_step",
    "init_decode_state", "init_params", "params_from_numpy", "prefill",
    "prefill_bucketed", "HostIO", "QKVOut", "check_supported",
]
