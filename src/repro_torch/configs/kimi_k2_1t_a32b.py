"""Kimi K2 -- trillion-param MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2; unverified]

head_dim=128 (64 heads x 128 > d_model is intentional -- DeepSeek-V3-family
geometry).
"""
from repro_torch.models.config import BlockKind, FFNKind, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=128,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.MOE,
    moe=MoEConfig(num_experts=384, top_k=8, expert_ffn_dim=2048,
                  num_shared_experts=1, shared_ffn_dim=2048),
)
