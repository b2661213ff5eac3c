"""InternLM2-1.8B — dense GQA. [arXiv:2403.17297; hf]"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
)
