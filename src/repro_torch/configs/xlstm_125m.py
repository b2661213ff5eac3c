"""xLSTM-125M — alternating mLSTM/sLSTM blocks. [arXiv:2405.04517; unverified]

Recurrent decode state is O(1): eligible for long_500k; APEX KV-offload
is inapplicable (no KV cache) — served GPU-only (DESIGN.md §5).
"""
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=(BlockKind.MLSTM, BlockKind.SLSTM),
    ffn_kind=FFNKind.NONE,
)
