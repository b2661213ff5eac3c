"""PaliGemma-3B — SigLIP + Gemma backbone. [arXiv:2407.07726; hf]

The SigLIP vision tower is a stub per the brief: inputs provide 256
precomputed patch embeddings which form a bidirectional (prefix-LM)
prefix ahead of the text tokens.  Gemma geometry: MQA (kv=1),
head_dim=256, tied embeddings.
"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
    tie_embeddings=True, frontend="vision", frontend_tokens=256,
)
