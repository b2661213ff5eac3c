"""Prometheus text-format rendering of pool + gateway telemetry.

One exposition pass over ``EngineStats.snapshot()`` per replica (the
stats-export surface in ``repro_torch.serving.lifecycle``) plus the
gateway's own request counters.  Output follows the Prometheus text
format v0.0.4: one ``# HELP``/``# TYPE`` pair per metric family, then
every labeled sample of that family — distributions with no samples
yet are skipped rather than emitted as NaN.

Port of ``repro/serving/gateway/metrics.py``: the same families and
label sets, and two pairs of the port's own: K/V used and reserved,
and host-job consumes and late polls.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# EngineStats.snapshot() key -> (family, type, help, extra labels)
_ENGINE_METRICS: Dict[str, Tuple[str, str, str, Dict[str, str]]] = {
    "iterations": ("iterations_total", "counter",
                   "Engine iterations executed", {}),
    "device_tokens": ("device_tokens_total", "counter",
                      "Tokens decoded on the device tier", {}),
    "host_tokens": ("host_tokens_total", "counter",
                    "Tokens decoded on the host tier", {}),
    "wall_time_seconds": ("wall_time_seconds_total", "counter",
                          "Wall time spent inside engine iterations", {}),
    "decode_iters_per_s": ("decode_iters_per_s", "gauge",
                           "Decode iterations per second (lifetime mean)",
                           {}),
    "tokens_per_s": ("tokens_per_s", "gauge",
                     "Generated tokens per second (lifetime mean)", {}),
    "migrations": ("migrations_total", "counter",
                   "Host-to-device tier promotions", {}),
    "preemptions": ("preemptions_total", "counter",
                    "Device-to-host preemptive demotions", {}),
    "preemption_requeues": ("preemption_requeues_total", "counter",
                            "Urgent requests kept queued at their EDF "
                            "position because no victim capacity existed",
                            {}),
    "preemption_recomputes": ("preemption_recomputes_total", "counter",
                              "Victims whose KV was dropped and replayed "
                              "from scratch (blocked or costed-out swaps)",
                              {}),
    "host_fallbacks": ("host_fallbacks_total", "counter",
                       "Host jobs abandoned by the watchdog and "
                       "recomputed exactly on the engine thread", {}),
    "host_breaker_trips": ("host_breaker_trips_total", "counter",
                           "Host-tier circuit-breaker trips (GPU_ONLY "
                           "pin for a cooldown)", {}),
    "cancelled": ("cancelled_total", "counter",
                  "Requests aborted by the client with resources freed",
                  {}),
    "degradation_level": ("degradation_level", "gauge",
                          "Graceful-degradation ladder rung over the "
                          "sliding pressure window (0=ok 1=prefix_evict "
                          "2=demote 3=recompute 4=shed)", {}),
    "deadline_misses": ("deadline_misses_total", "counter",
                        "First tokens delivered after the TTFT deadline",
                        {}),
    "deadline_rejections": ("deadline_rejections_total", "counter",
                            "Requests rejected with an impossible TTFT "
                            "deadline", {}),
    "device_occupancy": ("device_occupancy", "gauge",
                         "Mean occupied device slots per iteration", {}),
    "host_occupancy": ("host_occupancy", "gauge",
                       "Mean occupied host slots per iteration", {}),
    "kv_used_tokens": ("kv_used_tokens_total", "counter",
                       "Device KV positions holding tokens (decode slots, "
                       "staging and prefix rows), summed per iteration",
                       {}),
    "kv_reserved_tokens": ("kv_reserved_tokens_total", "counter",
                           "Device KV positions reserved by those rows, "
                           "summed per iteration", {}),
    "host_consumes": ("host_consumes_total", "counter",
                      "Tries to take the pending host-attention job", {}),
    "host_late_polls": ("host_late_polls_total", "counter",
                        "Tries that found the host job unfinished (the "
                        "host rows rode along untouched)", {}),
    "prefill_chunks": ("prefill_chunks_total", "counter",
                       "Chunked-prefill chunks executed", {}),
    "prefix_lookups": ("prefix_cache_lookups_total", "counter",
                       "Prefix-cache admission lookups", {}),
    "prefix_hits": ("prefix_cache_hits_total", "counter",
                    "Admissions that matched a cached prefix", {}),
    "prefix_hit_tokens": ("prefix_cache_hit_tokens_total", "counter",
                          "Prompt tokens served from the prefix cache "
                          "(prefill work skipped)", {}),
    "prefix_evictions": ("prefix_cache_evictions_total", "counter",
                         "Prefix-cache entries evicted (LRU drops and "
                         "pool reclaims)", {}),
    "prefix_demotions": ("prefix_cache_demotions_total", "counter",
                         "Prefix-cache entries demoted device-to-host",
                         {}),
    "prefix_device_bytes": ("prefix_cache_resident_bytes", "gauge",
                            "Cached prefix KV bytes resident per tier",
                            {"tier": "device"}),
    "prefix_host_bytes": ("prefix_cache_resident_bytes", "gauge",
                          "Cached prefix KV bytes resident per tier",
                          {"tier": "host"}),
    "host_pool_hot_bytes": ("host_pool_bytes", "gauge",
                            "Host KV pool bytes by state at the stored "
                            "dtype", {"state": "hot"}),
    "host_pool_compressed_bytes": ("host_pool_bytes", "gauge",
                                   "Host KV pool bytes by state at the "
                                   "stored dtype", {"state": "compressed"}),
    "host_pool_free_bytes": ("host_pool_bytes", "gauge",
                             "Host KV pool bytes by state at the stored "
                             "dtype", {"state": "free"}),
    "host_kv_dtype_bytes": ("host_kv_dtype_bytes", "gauge",
                            "Bytes per stored host-KV element (4=fp32, "
                            "1=int8)", {}),
    "host_pages_compressed": ("host_pages_compressed_total", "counter",
                              "Cold host KV pages compressed in place",
                              {}),
    "host_pages_decompressed": ("host_pages_decompressed_total", "counter",
                                "Compressed host KV pages rehydrated on "
                                "touch", {}),
    "host_compressed_ratio_ewma": ("host_compressed_ratio_ewma", "gauge",
                                   "EWMA of compressed/raw page size "
                                   "ratio", {}),
    "ttft_p50_seconds": ("ttft_seconds", "gauge",
                         "Time to first token", {"quantile": "0.5"}),
    "ttft_p95_seconds": ("ttft_seconds", "gauge",
                         "Time to first token", {"quantile": "0.95"}),
    "itl_p50_seconds": ("itl_seconds", "gauge",
                        "Inter-token latency", {"quantile": "0.5"}),
    "itl_p95_seconds": ("itl_seconds", "gauge",
                        "Inter-token latency", {"quantile": "0.95"}),
}

_PREFIX = "apex_engine_"


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Families:
    """Accumulates samples grouped by metric family so HELP/TYPE are
    emitted exactly once per family (repeating them is invalid)."""

    def __init__(self) -> None:
        self._order: List[str] = []
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._samples: Dict[str, List[str]] = {}

    def add(self, family: str, mtype: str, help_text: str,
            labels: Dict[str, str], value: float) -> None:
        if family not in self._meta:
            self._order.append(family)
            self._meta[family] = (mtype, help_text)
            self._samples[family] = []
        name = family
        if labels:
            name += "{" + ",".join(f'{k}="{v}"'
                                   for k, v in labels.items()) + "}"
        self._samples[family].append(f"{name} {_fmt(value)}")

    def render(self) -> str:
        lines: List[str] = []
        for family in self._order:
            mtype, help_text = self._meta[family]
            lines.append(f"# HELP {family} {help_text}")
            lines.append(f"# TYPE {family} {mtype}")
            lines.extend(self._samples[family])
        return "\n".join(lines) + "\n"


def render_prometheus(pool, gateway_counters: Optional[Dict[str, int]] = None
                      ) -> str:
    """Render the pool's per-replica engine stats plus the gateway's
    edge counters as a Prometheus exposition document."""
    fams = _Families()
    counters = gateway_counters or {}
    fams.add("apex_gateway_requests_total", "counter",
             "HTTP requests accepted by the gateway", {},
             counters.get("requests", 0))
    fams.add("apex_gateway_sse_streams_total", "counter",
             "Completed SSE token streams", {},
             counters.get("streams", 0))
    for code in ("429", "503"):
        fams.add("apex_gateway_shed_total", "counter",
                 "Requests shed at the edge by backpressure",
                 {"code": code}, counters.get(f"shed_{code}", 0))
    fams.add("apex_gateway_cancelled_total", "counter",
             "SSE streams whose client disconnected mid-generation "
             "(request aborted engine-side)", {},
             counters.get("cancelled", 0))
    fams.add("apex_gateway_errors_total", "counter",
             "Requests that failed inside the gateway", {},
             counters.get("errors", 0))
    fams.add("apex_pool_replicas", "gauge",
             "Configured replica count", {}, len(pool.replicas))
    fams.add("apex_pool_replicas_alive", "gauge",
             "Live replica count", {}, len(pool.live_replicas()))
    fams.add("apex_pool_respawns_total", "counter",
             "Replica respawns after driver crashes", {}, pool.respawns)
    fams.add("apex_pool_queue_depth", "gauge",
             "In-flight requests across live replicas", {}, pool.depth())
    for rep in pool.replicas:
        labels = {"replica": str(rep.index)}
        fams.add("apex_replica_up", "gauge",
                 "1 when the replica is live", labels, int(rep.alive))
        fams.add("apex_replica_generation", "gauge",
                 "Respawn generation of the replica", labels,
                 rep.generation)
        fams.add("apex_replica_load", "gauge",
                 "In-flight streams plus leases", labels, rep.load)
        if not rep.alive:
            continue
        fams.add("apex_replica_listener_errors_total", "counter",
                 "Stream-listener exceptions swallowed by the fan-out "
                 "path", labels, rep.listener_errors)
        snap = rep.server.stats.snapshot()
        for key, (family, mtype, help_text, extra) in \
                _ENGINE_METRICS.items():
            value = snap.get(key)
            if value is None:
                continue             # empty distribution: skip, not NaN
            fams.add(_PREFIX + family, mtype, help_text,
                     {**labels, **extra}, value)
    return fams.render()
