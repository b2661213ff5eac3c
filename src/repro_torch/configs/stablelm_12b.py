"""StableLM-2-12B — dense GQA transformer. [hf:stabilityai/stablelm-2-1_6b; hf]"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
)
