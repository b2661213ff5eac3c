"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes that each attention kernel call and each serving window need.

Frozen from ``chip_smoke.py`` (``PEAK_BYTES_PER_S``, ``PEAK_FLOPS``, the
decode byte bound over each row's length) and
``repro_torch/launch/analysis.py`` (``kernel_costs``, ``_attn_pairs``) at
commit 33acfed, with each call counted at the lengths it was given
rather than at its whole cache.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, fp32 off
# them, and HBM3 bandwidth.  A card set below 700 W runs slower; the
# record carries its power limit beside every share of these peaks.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float, dtype: str = "bfloat16"
               ) -> float:
    """The least time the card could take: the larger of operations over
    peak rate and bytes over peak bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def decode_attention_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                          el: int, lengths: Iterable[int]
                          ) -> tuple:
    """(flops, bytes) of one decode call: q (B, H, D) over each row's
    ``lengths[b]`` cached positions of k, v (B, S, KV, D).  Each K/V byte
    of a row's prefix is read once, q read and the output written once,
    the lengths read once."""
    b, h, d = q_shape
    kv = k_shape[2]
    n = int(sum(lengths))
    flops = 4.0 * n * h * d
    nbytes = 2.0 * n * kv * d * el + 2.0 * b * h * d * el + 4 * b
    return flops, nbytes


def prefill_attention_cost(q_shape: Sequence[int], k_shape: Sequence[int],
                           el: int, q_offset: Optional[Iterable[int]],
                           causal: bool = True) -> tuple:
    """(flops, bytes) of one prefill call: q (B, T, H, D) at positions
    ``q_offset[b] + i`` over k, v (B, S, KV, D), causal.  Visible pairs
    per row are sum_i min(off + i + 1, S); the K/V a row can see,
    min(off + T, S) positions, is read once; q read and out written
    once."""
    b, t, h, d = q_shape
    s, kv = k_shape[1], k_shape[2]
    offs = list(q_offset) if q_offset is not None else [0] * b
    pairs = 0
    kv_rows = 0
    for off in offs:
        off = int(off)
        if causal:
            # sum over i in [0, T) of min(off + i + 1, S)
            full = max(0, min(t, s - off))          # rows below the cap
            pairs += full * (off + 1) + full * (full - 1) // 2 \
                + (t - full) * s
            kv_rows += min(off + t, s)
        else:
            pairs += t * s
            kv_rows += s
    flops = 4.0 * pairs * h * d
    nbytes = 2.0 * b * t * h * d * el + 2.0 * kv_rows * kv * d * el + 4 * b
    return flops, nbytes


def model_sizes(cfg: dict) -> dict:
    """Parameter counts of a configuration file's model: the stack's
    bytes (all weights, read once an iteration), the parameters a token
    passes through (its k experts and the shared ones for an MoE), and
    K/V bytes per token (bf16, every layer)."""
    d = int(cfg["hidden_size"])
    h, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = int(cfg.get("head_dim") or d // h)
    layers = int(cfg["num_hidden_layers"])
    vocab = int(cfg["vocab_size"])
    attn = d * h * hd * 2 + d * kv * hd * 2
    if "n_routed_experts" in cfg:
        f = int(cfg["moe_intermediate_size"])
        e, k = int(cfg["n_routed_experts"]), int(cfg["num_experts_per_tok"])
        shared = int(cfg.get("n_shared_experts", 0)) * f
        ffn_all = 3 * d * f * e + 3 * d * shared
        ffn_active = 3 * d * f * k + 3 * d * shared
        router = d * e                      # fp32
    else:
        ffn_all = ffn_active = 3 * d * int(cfg["intermediate_size"])
        router = 0
    norms = 2 * d
    return {
        "weight_bytes": layers * (2 * (attn + ffn_all + norms) + 4 * router)
        + 2 * (2 * vocab * d + d),
        "active_params": layers * (attn + ffn_active + router),
        "unembed_params": vocab * d,
        "kv_bytes_per_token": 2 * layers * kv * hd * 2,
        "attn_flops_per_pair": 4 * h * hd * layers,
    }
