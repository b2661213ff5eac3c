"""Dense attention-only model of the port (config, layers, KV state, stack)."""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig
from repro_torch.models.model import (ModelParams, decode_step,
                                      init_decode_state, init_params,
                                      params_from_numpy, prefill,
                                      prefill_bucketed)
from repro_torch.models.transformer import HostIO, QKVOut

__all__ = [
    "BlockKind", "FFNKind", "ModelConfig", "ModelParams", "decode_step",
    "init_decode_state", "init_params", "params_from_numpy", "prefill",
    "prefill_bucketed", "HostIO", "QKVOut",
]
