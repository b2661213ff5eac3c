"""Llama-3-405B — dense GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
    rope_theta=500000.0,
)
