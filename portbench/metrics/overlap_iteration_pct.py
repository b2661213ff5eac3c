"""Share of the window's Algorithm 1 decisions that were async_overlap or
asym_pipeline (EngineStats.strategy_counts)."""


def read(rec):
    sc = rec["counters"].get("strategy_counts", {})
    total = sum(sc.values())
    if not total:
        return None
    return 100.0 * (sc.get("async_overlap", 0)
                    + sc.get("asym_pipeline", 0)) / total
