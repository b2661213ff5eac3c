"""Core layers on tensors: init, RMSNorm, RoPE, GQA projections, SwiGLU,
embed/unembed.

Parameters are plain dicts of tensors in the reference layout (weights
``(in_dim, out_dim)``, applied as ``x @ w``).  Casting order follows
``repro/models/layers.py`` exactly: RMSNorm and RoPE in fp32 with a cast
back, SiLU in fp32 then cast, linear products in the working dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initializers (the port's own random weights; the JAX reference's weights
# come across through ``models.model.params_from_numpy``)
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill ``w`` (..., in_dim, out_dim) in place: truncated normal
    (+-3 std) with fan-in std 1/sqrt(in_dim), drawn in fp32."""
    std = 1.0 / math.sqrt(w.shape[-2])
    for mat in w.reshape(-1, *w.shape[-2:]):
        tmp = torch.empty(mat.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=gen)
        mat.copy_(tmp * std)
    return w


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    for i in range(0, w.shape[0], 16384):       # bounded fp32 scratch
        rows = w[i:i + 16384]
        tmp = torch.randn(rows.shape, dtype=torch.float32, device=w.device,
                          generator=gen)
        rows.copy_(tmp * 0.02)
    return w


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS normalization in fp32 with cast back to the input dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """Inverse frequencies for RoPE; shape (head_dim // 2,), fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate channel halves.  x: (B, T, H, D); positions: (B, T)."""
    dtype = x.dtype
    angles = positions[..., :, None].float() * inv_freq      # (B, T, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (B, T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(dtype)


# ---------------------------------------------------------------------------
# Attention projections (the attention itself runs in ``kernels.ops``)
# ---------------------------------------------------------------------------


def qkv_project(params: Params, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                inv_freq: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-attention linear ops (the paper's "pr" stage).  x: (B, T, d)."""
    b, t, _ = x.shape
    q = (x @ params["wq"]).reshape(b, t, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, t, num_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, t, num_kv_heads, head_dim)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions,
                                                           inv_freq), v


def attention_output(params: Params, attn: torch.Tensor) -> torch.Tensor:
    """Output projection (part of the paper's "po" stage).  attn: (B,T,H,D)."""
    b, t, h, d = attn.shape
    return attn.reshape(b, t, h * d) @ params["wo"]


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu((x @ params["w_gate"]).float()).to(x.dtype)
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["embed"].T
