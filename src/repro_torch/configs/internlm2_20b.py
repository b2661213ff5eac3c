"""InternLM2-20B — dense GQA. [arXiv:2403.17297; hf]"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
)
