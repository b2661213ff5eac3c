"""Seeded weights in the port's ``ModelParams`` layout, made on the
device by one ``torch.Generator`` in one call a leaf (leaves are stacked
over the layers), in the dtype they are served in.

Linear weights are normal with std 1/sqrt(fan_in), the embedding normal
with std 0.02, norm scales one; the MoE router is fp32, as the port
holds it.  The same tensors go to the port and, cast to fp32 layer by
layer, to the reference.
"""
from __future__ import annotations

from typing import Dict

import torch


def _normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    w = torch.empty(shape, dtype=dtype, device=device)
    w.normal_(0.0, std, generator=gen)
    return w


def make_params(cfg, *, seed: int, device: torch.device):
    """``repro_torch.models.ModelParams`` for the registry config ``cfg``
    (dense or MoE attention stacks), drawn from ``seed``."""
    from repro_torch.models import ModelParams
    from repro_torch.models.config import BlockKind, FFNKind

    if cfg.block_pattern != (BlockKind.ATTN,):
        raise ValueError(f"{cfg.name}: the benchmark makes weights for "
                         "attention stacks only")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, cfg.param_dtype)
    d, hd, g = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers

    def dense(*shape, dtype=dt):
        return _normal(gen, (g,) + shape, shape[-2] ** -0.5, dtype, device)

    def ones():
        return torch.ones((g, d), dtype=dt, device=device)

    block: Dict[str, Dict[str, torch.Tensor]] = {
        "ln1": {"scale": ones()},
        "attn": {"wq": dense(d, cfg.num_heads * hd),
                 "wk": dense(d, cfg.num_kv_heads * hd),
                 "wv": dense(d, cfg.num_kv_heads * hd),
                 "wo": dense(cfg.num_heads * hd, d)},
        "ln2": {"scale": ones()},
    }
    if cfg.ffn_kind == FFNKind.MOE:
        m = cfg.moe
        e, f = m.num_experts, m.expert_ffn_dim
        ffn = {"router": dense(d, e, dtype=torch.float32),
               "we_gate": dense(e, d, f), "we_up": dense(e, d, f),
               "we_down": dense(e, f, d)}
        if m.num_shared_experts:
            s = m.num_shared_experts * m.shared_ffn_dim
            ffn.update(ws_gate=dense(d, s), ws_up=dense(d, s),
                       ws_down=dense(s, d))
        block["ffn"] = ffn
    else:
        block["ffn"] = {"w_gate": dense(d, cfg.d_ff),
                        "w_up": dense(d, cfg.d_ff),
                        "w_down": dense(cfg.d_ff, d)}
    embedding = {"embed": _normal(gen, (cfg.vocab_size, d), 0.02, dt,
                                  device),
                 "unembed": _normal(gen, (d, cfg.vocab_size), d ** -0.5, dt,
                                    device)}
    return ModelParams(embedding=embedding, blocks=(block,),
                       final_norm={"scale": torch.ones((d,), dtype=dt,
                                                       device=device)})


def plain_weights(params) -> Dict[str, object]:
    """The same tensors as a plain dict for the reference, which imports
    nothing of the port: ``layers`` maps leaf names to (L, ...) stacks."""
    block = params.blocks[0]
    layers = {}
    for sub in block.values():
        layers.update(sub)
    layers["ln1"] = block["ln1"]["scale"]
    layers["ln2"] = block["ln2"]["scale"]
    layers.pop("scale", None)
    return {"embed": params.embedding["embed"],
            "unembed": params.embedding["unembed"],
            "final_norm": params.final_norm["scale"],
            "layers": layers}
