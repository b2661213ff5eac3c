"""One run of one cell: set-up (weights, server, a warm-up of the cell's
traffic), the measured window, then the check against the reference.
Returns the result line's fields and the record the metric readers
read.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Optional

from portbench.harness import check, costs, spec, timeline, trace
from portbench.harness.serve import Client, Spans
from portbench.harness.traffic import Traffic
from portbench.harness.weights import make_params, plain_weights


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def model_config(config: dict):
    """The port's registry config named by the configuration file, held
    to the file's sizes."""
    from repro_torch.configs import get_config
    cfg = get_config(config["registry"])
    want = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps}
    if cfg.moe is not None:
        want.update(n_routed_experts=cfg.moe.num_experts,
                    num_experts_per_tok=cfg.moe.top_k,
                    moe_intermediate_size=cfg.moe.expert_ffn_dim,
                    n_shared_experts=cfg.moe.num_shared_experts)
    else:
        want["intermediate_size"] = cfg.d_ff
    bad = {k: (config[k], v) for k, v in want.items() if config[k] != v}
    if bad:
        raise ValueError(f"{config['name']}: the file and the registry's "
                         f"{cfg.name} differ (file, registry): {bad}")
    return cfg


def _stats(server) -> dict:
    import dataclasses
    st = server.stats
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, dict):
            out[f.name] = dict(v)
        elif isinstance(v, (int, float)):
            out[f.name] = v
    return out


def _required_s(rec: trace.Recorder, sizes: dict) -> float:
    """Sum over the window's iterations of the least time the card could
    take for that iteration's work: the weights read once, the decode
    rows' K/V read and written, each token's products with the
    parameters it passes through, and the real chunk tokens' attention.
    Host rows' attention runs on the host and is not counted."""
    per: dict = {}

    def acc(step, f, b):
        a = per.setdefault(step, [0.0, 0.0])
        a[0] += f
        a[1] += b

    kvt = sizes["kv_bytes_per_token"]
    layers_pairs = sizes["attn_flops_per_pair"]
    for step, q, k, el, lengths in rec.decode:
        n = [int(x) for x in lengths.tolist() if int(x) > 1]
        f, b = costs.decode_attention_cost(q, k, el, n)
        acc(step, f, b)
    for step, offs, lens in rec.chunks:
        for off, ln in zip(offs, lens):
            pairs = ln * off + ln * (ln + 1) // 2
            acc(step, layers_pairs * pairs, kvt * (off + ln))
    prev = None
    for step, c in rec.steps:
        if prev is not None:
            dev = c["device_tokens"] - prev["device_tokens"]
            host = c["host_tokens"] - prev["host_tokens"]
            chunk = c["chunk_tokens"] - prev["chunk_tokens"]
            emitted = dev + host
            f = 2.0 * sizes["active_params"] * (emitted + chunk) \
                + 2.0 * sizes["unembed_params"] * emitted
            b = kvt * (dev + chunk)
            if emitted + chunk or step in per:
                b += sizes["weight_bytes"]
            acc(step, f, b)
        prev = c
    return sum(costs.roofline_s(f, b) for f, b in per.values())


def run(cell: dict, *, seed: int, seconds: float, traced: bool,
        device: str, t_start: float, config: Optional[dict] = None,
        mix: Optional[dict] = None, model_cfg=None,
        check_cfg: Optional[dict] = None, check_requests: bool = True,
        params=None) -> dict:
    """Run ``cell`` once.  ``config``/``mix``/``model_cfg``/``check_cfg``
    stand in for the files and the registry (the CPU tests' reduced
    cell); ``params`` reuses weights already made from ``seed`` (the
    tools' sweeps)."""
    import torch
    from repro_torch.serving.api import InferenceServer, ServerConfig

    config = config or spec.load_config(cell["config"])
    mix = mix or spec.load_traffic(cell["traffic"])
    check_cfg = check_cfg or (spec.load_check(cell["name"]) if check_requests
                              else {"target_tokens": 0, "max_requests": 0})
    cfg = model_cfg or model_config(config)
    engine = dict(config["engine"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    if dev.type == "cuda":
        # the cell's kernels are built (first run in a checkout) and
        # loaded here, so no launch in the warm-up or the window pays it
        from repro_torch.kernels import build
        build.load_all(("decode_attention", "prefill_attention"))
        log(f"kernels loaded at {time.perf_counter() - t_start:.3f} s")
    if params is None:
        params = make_params(cfg, seed=seed, device=dev)
    if dev.type == "cuda":
        log(f"weights made at {time.perf_counter() - t_start:.3f} s; free "
            f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB")
    traffic = Traffic(mix, seed=seed, vocab=cfg.vocab_size,
                      cache_len=int(engine["cache_len"]))
    server = InferenceServer(cfg, params, ServerConfig(device=device,
                                                       **engine))
    if dev.type == "cuda":
        log(f"server built at {time.perf_counter() - t_start:.3f} s; free "
            f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB")
    spans = Spans(traced)
    client = Client(server, traffic, engine, spans=spans)
    client.start()
    client.warm_up(float(mix["warmup_s"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # --- the window ----------------------------------------------------
    log(f"warm-up: {client.steps} iterations, {len(client.all)} requests "
        f"submitted, {len(client.finished)} finished")
    client.step_times.clear()
    client.late.clear()
    rec = trace.Recorder() if traced else None
    prof_ctx = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof_ctx = profile(activities=acts)
    before = _stats(server)
    backlog_open = (len(client.live), server.pending)
    wrap = rec.wrapping(server.engine) if traced else contextlib.nullcontext()
    with prof_ctx as prof, wrap:
        if traced:
            rec.note_step(server.engine.stats)
            client.on_step = lambda: rec.note_step(server.engine.stats)
        t_open = time.perf_counter()
        setup_s = t_open - t_start
        with spans("window"):
            t_close = client.run_until(t_open + seconds)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        client.on_step = None
    after = _stats(server)
    backlog_close = (len(client.live), server.pending)
    window_s = t_close - t_open
    mem_peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)

    requests = [(t.due, list(t.times)) for t in client.all]
    record = {
        "setup_s": setup_s, "window_s": window_s, "t_open": t_open,
        "t_close": t_close, "requests": requests,
        "counters": timeline.counter_delta(before, after),
        "config": config, "mix": traffic.mix, "trace": None,
        # (requests in flight, of them queued) at the open and the close
        "backlog": [backlog_open, backlog_close],
    }
    log(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, "
        f"{record['counters'].get('iterations')} iterations, "
        f"{len(client.all)} requests submitted, "
        f"{len(client.finished)} finished, in flight / queued at open and "
        f"close {record['backlog']}, generator late by at most "
        f"{max(client.late, default=0.0):.4f} s over {len(client.late)} "
        f"submits, slowest iterations "
        f"{sorted(client.step_times)[-3:]} s, counters "
        f"{ {k: v for k, v in record['counters'].items() if v} }")

    attempted = len(client.all)
    failed = sum(1 for t in client.all if t.req.failed)
    sample = check.served(check.pick_sample(
        client.finished, seed, target_tokens=int(
            check_cfg["target_tokens"]),
        max_requests=int(check_cfg["max_requests"]),
        in_flight=list(client.live.values())))

    breakdown = None
    if traced:
        tl = trace.device_timeline(prof) if dev.type == "cuda" else \
            {"ops": [], "spans": []}
        win = [s for s in tl["spans"] if s[0] == "window"]
        t0, t1 = (win[0][1], win[0][2]) if win else (None, None)
        busy, gaps = trace.busy_and_gaps(tl["ops"], t0, t1)
        labels = [s for s in tl["spans"] if s[0] != "window"]
        gaps.sort(key=lambda g: g[0] - g[1])
        sizes = costs.model_sizes(config)
        dec_bound = pre_bound = 0.0
        for _, q, k, el, lengths in rec.decode:
            dec_bound += costs.roofline_s(*costs.decode_attention_cost(
                q, k, el, lengths.tolist()))
        for _, q, k, el, off, causal in rec.prefill:
            pre_bound += costs.roofline_s(*costs.prefill_attention_cost(
                q, k, el, None if off is None else off.tolist(), causal))
        record["trace"] = {
            "busy_s": busy / 1e9, "window_s": window_s,
            "decode_bound_s": dec_bound,
            "decode_device_s": trace.kernel_time_s(tl["ops"],
                                                   trace.DECODE_KERNELS),
            "prefill_bound_s": pre_bound,
            "prefill_device_s": trace.kernel_time_s(tl["ops"],
                                                    trace.PREFILL_KERNELS),
            "required_s": _required_s(rec, sizes),
            "ops": len(tl["ops"]),
        }
        breakdown = {
            "device_ops": trace.top_ops(tl["ops"]),
            "idle_gaps": [[trace.label_gap(labels, s, e), (e - s) / 1e9]
                          for s, e in gaps[:10]],
        }
        log(f"trace: {record['trace']}")
        del prof, tl

    # --- free the program's state, then the reference ------------------
    server.shutdown()
    client.server = None
    del server, client
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    checks = {"failed_requests": {"value": failed, "limit": 0}}
    correct = False
    if check_requests:
        t_ref = time.perf_counter()
        result_check = check.check_sample(config, plain_weights(params),
                                          sample)
        log(f"reference: {result_check} over {len(sample)} requests "
            f"({sum(s['host'] for s in sample)} decoded on the host, "
            f"{sum(s['turn'] > 0 for s in sample)} later turns) in "
            f"{time.perf_counter() - t_ref:.3f} s")
        judged, ok = check.judge(check_cfg, result_check)
        checks.update(judged)
        correct = failed == 0 and ok
    return {"record": record, "correct": correct, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": mem_peak,
            "breakdown": breakdown, "checks": checks, "sample": sample,
            "params": params}
