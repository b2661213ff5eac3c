"""Jamba-1.5-Large (398B) — Mamba+attention 1:7, MoE 16e top-2.
[arXiv:2403.19887; hf]

One attention layer per 8-layer period (9 KV-bearing layers of 72), an
MoE FFN on every second entry.  APEX offloads the attention layers' KV;
the deferred-sync window spans the 7 Mamba layers between attention
layers.
"""
from repro_torch.models.config import (BlockKind, FFNKind, MambaConfig,
                                       MoEConfig, ModelConfig)

_PATTERN = (BlockKind.MAMBA,) * 3 + (BlockKind.ATTN,) + (BlockKind.MAMBA,) * 4

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    block_pattern=_PATTERN, ffn_kind=FFNKind.MOE, moe_period=2,
    moe=MoEConfig(num_experts=16, top_k=2, expert_ffn_dim=24576),
    mamba=MambaConfig(state_dim=16, conv_dim=4, expand=2),
)
