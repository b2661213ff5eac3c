"""HuBERT-XLarge — encoder-only audio backbone. [arXiv:2106.07447; unverified]

Encoder-only => causal=False, no KV cache, no decode shapes (DESIGN.md §5).
The conv feature extractor is a stub: inputs are precomputed frame
embeddings (B, T, d_model); vocab=504 is the k-means unit codebook.
"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.DENSE,
    causal=False, frontend="audio",
)
