"""DeepSeekMoE-16B -- fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]
"""
from repro_torch.models.config import BlockKind, FFNKind, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    block_pattern=(BlockKind.ATTN,), ffn_kind=FFNKind.MOE,
    moe=MoEConfig(num_experts=64, top_k=6, expert_ffn_dim=1408,
                  num_shared_experts=2, shared_ffn_dim=1408),
)
