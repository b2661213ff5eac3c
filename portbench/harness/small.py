"""A cell at a size the CPU runs in seconds, for the benchmark's tests:
the registry config reduced in width and depth, its configuration file's
keys worked out from it, small engine settings and short traffic."""
from __future__ import annotations

import contextlib
import dataclasses
import functools


def reduced_config(registry: str, *, layers: int = 2, d_model: int = 64,
                   vocab: int = 128):
    """(the port's reduced ModelConfig, the matching configuration
    file's keys with small engine settings)."""
    from repro_torch.configs import get_config
    cfg = get_config(registry).reduced(layers=layers, d_model=d_model,
                                       vocab=vocab)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    keys = {"name": cfg.name, "registry": registry,
            "hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps}
    if cfg.moe is not None:
        keys.update(n_routed_experts=cfg.moe.num_experts,
                    num_experts_per_tok=cfg.moe.top_k,
                    moe_intermediate_size=cfg.moe.expert_ffn_dim,
                    n_shared_experts=cfg.moe.num_shared_experts,
                    norm_topk_prob=True)
    else:
        keys["intermediate_size"] = cfg.d_ff
    keys["engine"] = {"device_slots": 2, "host_slots": 2,
                      "prefix_cache_slots": 1, "cache_len": 96,
                      "chunk_tokens": 16, "page_size": 8,
                      "host_pool_pages": 256, "host_kv_budget_tokens": 192,
                      "host_workers": 1, "perf_model": "analytic"}
    return cfg, keys


@contextlib.contextmanager
def fp32_caches():
    """The serving engine keeps its K/V caches in bfloat16 whatever the
    compute dtype, which moves a reduced model's logits by ~1e-2 and
    flips its near-tied greedy tokens.  Inside this context the engine
    and the prefill path make them in float32, so the reduced cell is
    fp32 end to end and its tokens are the fp32 reference's own best."""
    import torch
    from repro_torch import models
    from repro_torch.serving import engine, prefill_exec
    fp32 = functools.partial(models.init_decode_state,
                             kv_dtype=torch.float32)
    saved = [(m, m.init_decode_state) for m in (engine, prefill_exec)]
    try:
        for m, _ in saved:
            m.init_decode_state = fp32
        yield
    finally:
        for m, fn in saved:
            m.init_decode_state = fn


def small_checks(target_tokens: int = 32) -> dict:
    """The reduced cell's check: the fp32 program (under
    ``fp32_caches``) against the fp32 reference, so the served tokens are
    the reference's own best."""
    return {"limits": {"mean_logit_gap": 1e-4},
            "target_tokens": target_tokens, "max_requests": 256,
            "min_tokens": 4}


def small_mix(kind: str = "offload-chat") -> dict:
    """Short traffic of each shape."""
    base = {"turns": 1, "shared_prefix": 0, "think_s": 0.0,
            "warmup_s": 0.5,
            "user": {"mean": 24, "cv": 0.8, "min": 2, "max": "fit"},
            "reply": {"mean": 6, "cv": 0.8, "min": 1, "max": 12}}
    if kind == "offload-chat":
        return dict(base, loop="closed",
                    clients_from=["device_slots", "host_slots"])
    if kind == "prefix-chat":
        return dict(base, loop="open", rate_per_s=20.0, turns=2,
                    shared_prefix=16, think_s=0.05,
                    user={"mean": 8, "cv": 0.8, "min": 2, "max": 16},
                    reply={"mean": 6, "cv": 0.8, "min": 1, "max": 10})
    return dict(base, loop="closed", clients_from=["device_slots"])
