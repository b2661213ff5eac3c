"""Seconds the engine waited on the host tier, per iteration of the
window (EngineStats.host_wait_time)."""


def read(rec):
    c = rec["counters"]
    n = c.get("iterations", 0)
    return 1e3 * c.get("host_wait_time", 0.0) / n if n else None
