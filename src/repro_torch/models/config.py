"""Model configuration covering every assigned architecture family.

One ``ModelConfig`` dataclass describes dense GQA transformers, MoE
transformers (shared + routed experts), hybrid Mamba/attention stacks
(Jamba), xLSTM stacks (sLSTM + mLSTM blocks), encoder-only audio
backbones (HuBERT) and VLM text backbones (PaliGemma).  The block
layout is expressed as a *pattern* — a short cyclic list of block kinds
that tiles the depth; parameters and decode states are stacked over the
pattern's repetitions ("groups"), so layer = g * period + j.

Port of ``repro/models/config.py`` (kept as a copy: the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple


class BlockKind(str, enum.Enum):
    """Kinds of residual blocks a model may stack."""

    ATTN = "attn"          # attention + (dense FFN | MoE FFN)
    MAMBA = "mamba"        # Mamba-1 selective-scan block (+ FFN for Jamba)
    SLSTM = "slstm"        # xLSTM sLSTM block
    MLSTM = "mlstm"        # xLSTM mLSTM block


class FFNKind(str, enum.Enum):
    DENSE = "dense"        # SwiGLU MLP
    MOE = "moe"            # token-choice top-k routed experts (+ shared experts)
    NONE = "none"          # block has no FFN sub-layer (xLSTM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int                 # routed experts
    top_k: int                       # experts per token
    expert_ffn_dim: int              # hidden dim of each routed expert
    num_shared_experts: int = 0      # always-on shared experts
    shared_ffn_dim: int = 0          # hidden dim of the shared expert(s)
    router_jitter: float = 0.0       # router noise (train only)
    aux_loss_coef: float = 0.001     # load-balance auxiliary loss weight

    @property
    def active_ffn_dim(self) -> int:
        """Total FFN hidden dim active per token (for FLOP accounting)."""
        return self.top_k * self.expert_ffn_dim + self.num_shared_experts * self.shared_ffn_dim


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block configuration."""

    state_dim: int = 16              # N — SSM state size per channel
    conv_dim: int = 4                # depthwise conv kernel width
    expand: int = 2                  # inner dim = expand * d_model
    dt_rank: Optional[int] = None    # Δ projection rank (default ceil(d_model/16))

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, math.ceil(d_model / 16))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single config object that describes every supported family."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None               # default d_model // num_heads

    # --- block layout -----------------------------------------------------
    # `block_pattern` tiles the depth; e.g. Jamba = 7×MAMBA + 1×ATTN.
    block_pattern: Tuple[BlockKind, ...] = (BlockKind.ATTN,)
    ffn_kind: FFNKind = FFNKind.DENSE
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # MoE FFN on every `moe_period`-th pattern entry (Jamba alternates
    # MoE and dense FFNs); dense elsewhere. 1 = MoE everywhere.
    moe_period: int = 1

    # --- architectural knobs ----------------------------------------------
    causal: bool = True                           # False for encoder-only
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 131072

    # --- modality frontend (stubbed per brief) -----------------------------
    # "none"  : token ids in, embedding table lookup
    # "audio" : precomputed frame embeddings in (hubert)
    # "vision": precomputed patch embeddings prepended to text (paligemma)
    frontend: str = "none"
    frontend_tokens: int = 0                      # e.g. #patches for the VLM stub

    # --- dtype policy -------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.num_kv_heads}"
            )
        if self.ffn_kind == FFNKind.MOE and self.moe is None:
            raise ValueError(f"{self.name}: MoE ffn_kind requires a MoEConfig")
        if any(k == BlockKind.MAMBA for k in self.block_pattern) and self.mamba is None:
            raise ValueError(f"{self.name}: MAMBA blocks require a MambaConfig")
        if self.num_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {len(self.block_pattern)}"
            )

    def ffn_kind_for_entry(self, entry_idx: int) -> FFNKind:
        """FFN kind of pattern entry `entry_idx` (MoE/dense interleave)."""
        if self.ffn_kind != FFNKind.MOE or self.moe_period == 1:
            return self.ffn_kind
        return (FFNKind.MOE if entry_idx % self.moe_period == self.moe_period - 1
                else FFNKind.DENSE)

    # --- derived sizes ------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        """Number of scan steps (pattern repetitions) in the stack."""
        return self.num_layers // self.pattern_period

    @property
    def attn_layer_indices(self) -> Tuple[int, ...]:
        """Absolute indices of layers that carry a KV cache."""
        out = []
        for i in range(self.num_layers):
            if self.block_pattern[i % self.pattern_period] == BlockKind.ATTN:
                out.append(i)
        return tuple(out)

    @property
    def num_attn_layers(self) -> int:
        return len(self.attn_layer_indices)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_kv_cache(self) -> bool:
        """True iff autoregressive decode carries an attention KV cache."""
        return self.causal and self.num_attn_layers > 0

    @property
    def is_recurrent_decode(self) -> bool:
        """True iff decode state is O(1) in sequence length (SSM/xLSTM)."""
        return self.causal and all(
            k in (BlockKind.MAMBA, BlockKind.SLSTM, BlockKind.MLSTM)
            for k in self.block_pattern
        )

    @property
    def supports_long_context_decode(self) -> bool:
        """Sub-quadratic decode: recurrent or hybrid (mostly-recurrent) stacks."""
        return self.causal and any(
            k in (BlockKind.MAMBA, BlockKind.SLSTM, BlockKind.MLSTM)
            for k in self.block_pattern
        )

    @property
    def has_recurrent(self) -> bool:
        """True iff any block carries recurrent (SSM/xLSTM) state.

        The single source of truth for "is this a hybrid stack" —
        serving code must use this instead of re-deriving it from
        ``block_pattern`` so tier-move/migration special cases cannot
        drift.  Purely structural (unlike ``supports_long_context_decode``
        it does not require ``causal``).
        """
        return any(k != BlockKind.ATTN for k in self.block_pattern)

    # --- parameter counting (used by roofline + DESIGN tables) --------------
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q_dim = self.num_heads * hd
        kv_dim = self.num_kv_heads * hd
        per_layer = 0
        for j, kind in enumerate(self.block_pattern):
            if kind == BlockKind.ATTN:
                attn = d * q_dim + 2 * d * kv_dim + q_dim * d
                per_layer += attn + self._ffn_params(j) + 2 * d  # 2 norms
            elif kind == BlockKind.MAMBA:
                assert self.mamba is not None
                m = self.mamba
                inner = m.expand * d
                dtr = m.resolved_dt_rank(d)
                blk = (
                    d * 2 * inner              # in_proj (x and gate)
                    + inner * m.conv_dim       # depthwise conv
                    + inner * (dtr + 2 * m.state_dim)  # x -> (dt, B, C)
                    + dtr * inner              # dt_proj
                    + inner * m.state_dim      # A_log
                    + inner                    # D
                    + inner * d                # out_proj
                )
                per_layer += blk + d           # norm
                if self.ffn_kind != FFNKind.NONE:
                    per_layer += self._ffn_params(j) + d
            elif kind in (BlockKind.SLSTM, BlockKind.MLSTM):
                # xLSTM blocks: gates + projections, approx 4 matrices of d*d
                # per head-group plus up/down projections.
                proj_factor = 2 if kind == BlockKind.MLSTM else 1
                inner = proj_factor * d
                per_layer += 4 * inner * inner // max(self.num_heads, 1) * self.num_heads \
                    + 2 * d * inner + 2 * d
        # average over pattern then multiply by depth
        stack = per_layer * self.num_groups
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return stack + embed + head + d  # final norm

    def _ffn_params(self, entry_idx: int = 0) -> int:
        d = self.d_model
        kind = self.ffn_kind_for_entry(entry_idx)
        if kind == FFNKind.DENSE:
            return 3 * d * self.d_ff  # SwiGLU: gate, up, down
        if kind == FFNKind.MOE:
            assert self.moe is not None
            routed = self.moe.num_experts * 3 * d * self.moe.expert_ffn_dim
            shared = self.moe.num_shared_experts * 3 * d * self.moe.shared_ffn_dim
            router = d * self.moe.num_experts
            return routed + shared + router
        return 0

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if self.ffn_kind != FFNKind.MOE:
            return self.param_count()
        assert self.moe is not None
        d = self.d_model
        active_moe = 3 * d * self.moe.active_ffn_dim + d * self.moe.num_experts
        delta = 0
        for j in range(self.pattern_period):
            if self.ffn_kind_for_entry(j) == FFNKind.MOE:
                delta += self._ffn_params(j) - active_moe
        return self.param_count() - delta * self.num_groups

    def kv_cache_bytes(self, seq_len: int, batch: int, bytes_per_el: int = 2) -> int:
        """Total KV cache footprint for `batch` sequences of `seq_len`."""
        return (
            2 * self.num_attn_layers * self.num_kv_heads * self.resolved_head_dim
            * seq_len * batch * bytes_per_el
        )

    # --- reduced configs for smoke tests ------------------------------------
    def reduced(self, *, layers: int = None, d_model: int = 64,
                vocab: int = 128) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        period = self.pattern_period
        if layers is None:
            layers = 2 * period
        layers = max(period, (layers // period) * period)
        heads = 4
        kv = min(self.num_kv_heads, heads) or 1
        kv = heads // max(1, heads // kv)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(8, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), expert_ffn_dim=32,
                shared_ffn_dim=32 if self.moe.num_shared_experts else 0,
            )
        mamba = self.mamba
        if mamba is not None:
            mamba = dataclasses.replace(mamba, state_dim=8, dt_rank=8)
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=layers,
            d_model=d_model, num_heads=heads, num_kv_heads=kv,
            d_ff=4 * d_model if self.d_ff else 0, vocab_size=vocab,
            head_dim=d_model // heads, moe=moe, mamba=mamba,
            frontend_tokens=min(self.frontend_tokens, 16),
            max_seq_len=512,
        )


def repeat_pattern(pattern: Sequence[BlockKind], layers: int) -> Tuple[BlockKind, ...]:
    """Validate that `pattern` tiles `layers` and return it as a tuple."""
    pattern = tuple(pattern)
    if layers % len(pattern) != 0:
        raise ValueError(f"pattern of period {len(pattern)} does not tile {layers} layers")
    return pattern
