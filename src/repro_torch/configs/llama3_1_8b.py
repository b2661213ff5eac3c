"""LLaMa-3.1-8B — the paper's A10-platform model. [arXiv:2407.21783; hf]"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
    rope_theta=500000.0,
)
