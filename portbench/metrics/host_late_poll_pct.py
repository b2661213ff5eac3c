"""Share of the window's tries to take the pending host-attention job
that found it unfinished, so the host rows rode the iteration untouched
(EngineStats host_late_polls / host_consumes)."""


def read(rec):
    c = rec["counters"]
    n = c.get("host_consumes", 0)
    return 100.0 * c.get("host_late_polls", 0) / n if n else None
