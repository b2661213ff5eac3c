"""Plain fp32 PyTorch reference of the benchmark's attention stacks, with
no kernel, cache or batching of the program under test.

Dense GQA with RoPE (channel halves rotated, inverse frequencies
1 / theta^(2i / D)), RMSNorm, SwiGLU, or the DeepSeek-MoE FFN: softmax
router in fp32, the top-k experts (ties to the lower expert id),
their probabilities renormalised to sum to one, each token's output the
probability-weighted sum of its experts' SwiGLU plus the shared experts'
SwiGLU.  Every token gets all k of its experts (no capacity).

It reads a configuration file's keys (``hidden_size``,
``num_attention_heads``, ...) and a plain dict of weight tensors
(``embed`` (V, d), ``unembed`` (d, V), ``final_norm`` (d,), ``layers``:
leaf name -> (L, ...) stack with weights laid out (in, out)).  Weights
are cast to fp32 one layer at a time, and all sequences advance through
a layer together, so the reference holds one layer in fp32 at a time.

``precision="int8"`` is the control: every product with a weight runs on
int8 values (weights per output channel, activations per token,
symmetric), the rest as in fp32.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to symmetric int8 along ``dim``'s maximum, back in fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class _Linear:
    def __init__(self, precision: str) -> None:
        if precision not in ("fp32", "int8"):
            raise ValueError(f"precision {precision!r}")
        self.int8 = precision == "int8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) @ w (in, out) in fp32 or on int8 values."""
        if self.int8:
            return _q8(x, -1) @ _q8(w, -2)
        return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) at positions 0..T-1."""
    t, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Causal GQA softmax attention: q (T, H, D), k, v (T, KV, D)."""
    t, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("thd,shd->hts", q, k) / d ** 0.5
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(scores, -1), v)


def _swiglu(lin: _Linear, x, w_gate, w_up, w_down):
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def _moe(cfg: dict, lin: _Linear, x: torch.Tensor, lw: Dict[str, torch.Tensor]
         ) -> torch.Tensor:
    k = int(cfg["num_experts_per_tok"])
    probs = torch.softmax(lin(x, lw["router"]), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[:, :k], ids[:, :k]
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(int(cfg["n_routed_experts"])):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(lin, x[tok], lw["we_gate"][e], lw["we_up"][e],
                    lw["we_down"][e])
        out.index_add_(0, tok, y * top_p[tok, slot][:, None])
    if int(cfg.get("n_shared_experts", 0)):
        out = out + _swiglu(lin, x, lw["ws_gate"], lw["ws_up"],
                            lw["ws_down"])
    return out


def _layer_fp32(weights: dict, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i].float() for name, w in weights["layers"].items()}


def logits_at(cfg: dict, weights: dict, seqs: Sequence[Sequence[int]],
              wanted: Sequence[Sequence[int]], *, precision: str = "fp32"
              ) -> List[torch.Tensor]:
    """For each token sequence, the logits (len(wanted[s]), V) fp32 of
    the next token at the positions ``wanted[s]``."""
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(cfg, weights, seqs, wanted, _Linear(precision))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32


@torch.no_grad()
def _logits_at(cfg, weights, seqs, wanted, lin: _Linear):
    dev = weights["embed"].device
    d = int(cfg["hidden_size"])
    h, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = int(cfg.get("head_dim") or d // h)
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    moe = "n_routed_experts" in cfg
    xs = [weights["embed"][torch.as_tensor(list(s), device=dev)].float()
          for s in seqs]
    for i in range(int(cfg["num_hidden_layers"])):
        lw = _layer_fp32(weights, i)
        for j, x in enumerate(xs):
            t = x.shape[0]
            a = _rmsnorm(x, lw["ln1"], eps)
            q = _rope(lin(a, lw["wq"]).view(t, h, hd), theta)
            k = _rope(lin(a, lw["wk"]).view(t, kv, hd), theta)
            v = lin(a, lw["wv"]).view(t, kv, hd)
            x = x + lin(_attention(q, k, v).reshape(t, h * hd), lw["wo"])
            a = _rmsnorm(x, lw["ln2"], eps)
            if moe:
                x = x + _moe(cfg, lin, a, lw)
            else:
                x = x + _swiglu(lin, a, lw["w_gate"], lw["w_up"],
                                lw["w_down"])
            xs[j] = x
        del lw
    unembed = weights["unembed"].float()
    norm = weights["final_norm"].float()
    out = []
    for x, pos in zip(xs, wanted):
        rows = x[torch.as_tensor(list(pos), device=dev)]
        out.append(lin(_rmsnorm(rows, norm, eps), unembed))
    return out
