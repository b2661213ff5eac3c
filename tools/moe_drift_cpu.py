#!/usr/bin/env python3
"""The int8 host tier's logit drift on an MoE stack, in the reference
and in the port, on the CPU.

    PYTHONPATH=src python3 tools/moe_drift_cpu.py [--layers 4] [--seeds 0 1 2]
        [--stacks moe dense] [--fp32]

Like the tests, this runs both packages on the same inputs.  For each seed
the reference's weights (``jax.random.PRNGKey(seed)``) are carried into the
port, and the same prompts (``numpy.random.default_rng(seed)``) go through
the reference's ``Engine`` and the port's, once with the fp32 host pool
and once with the int8 pool.  The geometry is deepseek-moe-16b narrowed to
d_model 512: 4 heads of 128, 64 experts top-6 of width 96 plus 2 shared,
vocab 2048.  A dense twin with one FFN of width 768 in place of the MoE
runs beside it.  The traffic is chip_smoke.py's serving-moe: 8 requests
of 128 -> 16 tokens over 2 device + 4 host slots, cache_len 512,
whole-prompt bucketed prefill, no tier moves or prefix cache.

Algorithm 1 is pinned to Asymmetric Pipelining in both engines, so every
host job is waited for and no run depends on host timing.  Each token's
logit row is filed under (request, token index).  The drift is
chip_smoke.py's: the largest |int8 - fp32| logit over each request's
tokens up to the first where its two streams part.  The top-2 gap of the
fp32 logits at such a parting is printed beside it.  The same measure
between the two packages, pool for pool, shows whether the port computes
what the reference computes.  The reference's envelope, from its reduced
models, is 0.75.  One engine run takes seconds to tens of seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SERVE = dict(device_slots=2, host_slots=4, cache_len=512, page_size=32,
             prompt_len=128, output_len=16, requests=8)


def _configs(layers: int):
    """(reference, port) configs of the MoE geometry and of its dense twin."""
    from repro.configs import get_config as ref_get_config
    from repro.models.config import FFNKind as RefFFN
    from repro.models.config import MoEConfig as RefMoE
    from repro_torch.configs import get_config
    from repro_torch.models.config import FFNKind, MoEConfig
    narrow = dict(num_layers=layers, d_model=512, num_heads=4,
                  num_kv_heads=4, head_dim=128, vocab_size=2048)
    experts = dict(num_experts=64, top_k=6, expert_ffn_dim=96,
                   num_shared_experts=2, shared_ffn_dim=96)
    out = {}
    for pkg, get, moe_cls, dense_kind in (
            ("ref", ref_get_config, RefMoE, RefFFN.DENSE),
            ("port", get_config, MoEConfig, FFNKind.DENSE)):
        moe = dataclasses.replace(get("deepseek-moe-16b"),
                                  name="deepseek-moe-d512",
                                  moe=moe_cls(**experts), **narrow)
        dense = dataclasses.replace(moe, name="dense-d512",
                                    ffn_kind=dense_kind, moe=None, d_ff=768)
        out[pkg] = {"moe": moe, "dense": dense}
    return out


def _pinned(decision_cls, kind):
    """An Algorithm 1 that always picks Asymmetric Pipelining."""
    class Pinned:
        def schedule(self, prefill, decode_gpu, decode_cpu, *, mean_context,
                     prefill_tokens=0, chunk_backlog_tokens=0,
                     chunk_tokens_max=0):
            return decision_cls(kind, list(prefill), list(decode_gpu),
                                list(decode_cpu),
                                chunk_tokens=min(chunk_backlog_tokens,
                                                 chunk_tokens_max))
    return Pinned()


class _Keyed(list):
    """A request's output list that, on each append, files the logit row
    its token came from under (request, token index).  Every engine
    appends a sampled call's tokens right after the call and in row
    order, so the row is the one after the call's last claimed row that
    holds this greedy token; where two such rows hold it (a row sampled
    but not appended, such as a device row beside the host rows, can
    share it), the token is filed with no row and the drift skips it."""

    def __init__(self, rec, rows, i):
        super().__init__()
        self.rec, self.rows, self.i = rec, rows, i

    def append(self, tok):
        tok = int(tok)
        logits, toks, claimed = self.rec[-1]
        after = max(claimed, default=-1)
        match = [r for r in range(after + 1, len(toks)) if toks[r] == tok]
        if not match:
            raise AssertionError("a token with no row in the newest call")
        if len(match) == 1:
            claimed.add(match[0])
        self.rows[(self.i, len(self))] = (logits[match[0]]
                                          if len(match) == 1 else None)
        return super().append(tok)


def _run(pkg: str, cfg, params, prompts, host_kv_dtype: str):
    """One engine run of the traffic: (the logit row of every token keyed
    by (request index, token index), streams, host tokens)."""
    import numpy as np
    if pkg == "ref":
        from repro.core.scheduler import Decision, StrategyKind
        from repro.serving import Engine, EngineConfig
        from repro.serving import engine as eng_mod
        from repro.serving import prefill_exec
        from repro.serving.request import Request
        from repro.serving.sampler import sample
        extra = {}
    else:
        from repro_torch.core.scheduler import Decision, StrategyKind
        from repro_torch.serving import Engine, EngineConfig, Request
        from repro_torch.serving import engine as eng_mod
        from repro_torch.serving import prefill_exec
        from repro_torch.serving.sampler import sample
        extra = {"device": "cpu"}
    rec, rows = [], {}

    def spy(logits, **kw):
        toks = sample(logits, **kw)
        rec.append((np.asarray(logits if pkg == "ref" else logits.float(),
                               np.float32).reshape(-1, cfg.vocab_size),
                    np.asarray(toks).reshape(-1).tolist(), set()))
        return toks

    per = -(-(SERVE["prompt_len"] + SERVE["output_len"])
            // SERVE["page_size"])
    ecfg = EngineConfig(
        device_slots=SERVE["device_slots"], host_slots=SERVE["host_slots"],
        cache_len=SERVE["cache_len"], page_size=SERVE["page_size"],
        host_pool_pages=cfg.num_attn_layers * SERVE["host_slots"] * per,
        chunk_tokens=0, prefix_cache=False, tier_rebalance=False,
        preemption=False, host_kv_dtype=host_kv_dtype, **extra)
    reqs = [Request(prompt=list(p), max_new_tokens=SERVE["output_len"])
            for p in prompts]
    for i, r in enumerate(reqs):
        r.output = _Keyed(rec, rows, i)
    saved = eng_mod.sample, prefill_exec.sample
    eng_mod.sample = prefill_exec.sample = spy
    try:
        eng = Engine(cfg, params, ecfg, scheduler=_pinned(
            Decision, StrategyKind.ASYM_PIPELINE))
        try:
            stats = eng.run(reqs)
        finally:
            eng.shutdown()
    finally:
        eng_mod.sample, prefill_exec.sample = saved
    return rows, [list(r.output) for r in reqs], stats.host_tokens


def _drift(a, b):
    """chip_smoke.py's logit_drift: the largest |a - b| logit over each
    request's tokens up to and including the first where its two streams
    part; (that drift, the smallest top-2 gap of a's logits at a parting
    or None, streams that part, tokens skipped for want of a row)."""
    import numpy as np
    a_rows, a_out, _ = a
    b_rows, b_out, _ = b
    drift, gap, skipped = 0.0, None, 0
    for i, (x, y) in enumerate(zip(a_out, b_out)):
        for j in range(min(len(x), len(y))):
            ra, rb = a_rows[(i, j)], b_rows[(i, j)]
            if ra is None or rb is None:
                skipped += 1
            else:
                drift = max(drift, float(np.abs(ra - rb).max()))
            if x[j] != y[j]:
                if ra is not None:
                    top2 = np.sort(ra)[-2:]
                    g = float(top2[1] - top2[0])
                    gap = g if gap is None else min(gap, g)
                break
    return drift, gap, sum(x != y for x, y in zip(a_out, b_out)), skipped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--stacks", nargs="+", default=["moe", "dense"],
                    choices=["moe", "dense"])
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 parameters and compute (default: the "
                    "config's bf16)")
    args = ap.parse_args()
    import jax
    import numpy as np
    import torch
    from repro.models import init_params as ref_init
    from repro_torch.models import params_from_numpy
    torch.manual_seed(0)
    cfgs = _configs(args.layers)
    print("drift: max |int8 - fp32| logit within a package; across: max "
          "|port - reference| logit with the same pool (fp32 / int8); gap: "
          "the smallest fp32 top-2 gap where an int8 stream parts; "
          "skipped: tokens of the six comparisons whose row was ambiguous",
          flush=True)
    print(f"{'stack':18} {'seed':>4} {'ref drift':>9} {'port drift':>10} "
          f"{'ref gap':>8} {'port gap':>8} {'parted ref/port':>15} "
          f"{'across fp32/int8':>17} {'host tokens':>11} {'skipped':>7}",
          flush=True)
    for stack in args.stacks:
        rcfg, cfg = cfgs["ref"][stack], cfgs["port"][stack]
        if args.fp32:
            dt = dict(param_dtype="float32", compute_dtype="float32")
            rcfg = dataclasses.replace(rcfg, **dt)
            cfg = dataclasses.replace(cfg, **dt)
        for seed in args.seeds:
            t0 = time.perf_counter()
            rparams = ref_init(jax.random.PRNGKey(seed), rcfg)
            params = params_from_numpy(
                cfg, jax.tree.map(np.asarray, rparams), "cpu")
            rng = np.random.default_rng(seed)
            prompts = [rng.integers(0, cfg.vocab_size,
                                    SERVE["prompt_len"]).tolist()
                       for _ in range(SERVE["requests"])]
            runs = {(pkg, dt): _run(pkg, c, p, prompts, dt)
                    for pkg, c, p in (("ref", rcfg, rparams),
                                      ("port", cfg, params))
                    for dt in ("fp32", "int8")}
            own = {pkg: _drift(runs[pkg, "fp32"], runs[pkg, "int8"])
                   for pkg in ("ref", "port")}
            across = [_drift(runs["ref", dt], runs["port", dt])
                      for dt in ("fp32", "int8")]
            skipped = sum(d[3] for d in (*own.values(), *across))

            def gap(g):
                return "none" if g is None else f"{g:.4f}"
            print(f"{cfg.name:18} {seed:>4} {own['ref'][0]:9.4f} "
                  f"{own['port'][0]:10.4f} {gap(own['ref'][1]):>8} "
                  f"{gap(own['port'][1]):>8} "
                  f"{own['ref'][2]:>7}/{own['port'][2]:<7} "
                  f"{across[0][0]:8.4f}/{across[1][0]:<8.4f} "
                  f"{runs['port', 'int8'][2]:>11} {skipped:>7}   "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
