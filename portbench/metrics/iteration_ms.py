"""Window over the engine iterations run in it (EngineStats)."""


def read(rec):
    n = rec["counters"].get("iterations", 0)
    return 1e3 * rec["window_s"] / n if n else None
