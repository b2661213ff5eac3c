"""Model of the port: config, layers, KV and recurrent state, the block
stack."""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig
from repro_torch.models.graphs import StepGraphs
from repro_torch.models.model import (ModelParams, abstract_params,
                                      capture_chunk, capture_decode,
                                      decode_step,
                                      decode_with_chunked_prefill,
                                      forward_hidden, forward_train,
                                      init_decode_state, init_params,
                                      params_from_numpy, prefill,
                                      prefill_bucketed, prefill_chunk)
from repro_torch.models.transformer import HostIO, QKVOut

__all__ = [
    "BlockKind", "FFNKind", "ModelConfig", "ModelParams", "StepGraphs",
    "abstract_params", "capture_chunk", "capture_decode", "decode_step",
    "decode_with_chunked_prefill", "forward_hidden", "forward_train",
    "init_decode_state", "init_params", "params_from_numpy", "prefill",
    "prefill_bucketed", "prefill_chunk", "HostIO", "QKVOut",
]
