"""LLaMa-2-7B — the paper's T4-platform model. [arXiv:2307.09288; hf]"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
)
