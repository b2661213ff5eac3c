"""|sum predicted - sum observed| / sum observed step time of the window's
iterations that Algorithm 1 priced (EngineStats)."""


def read(rec):
    c = rec["counters"]
    obs = c.get("observed_time", 0.0)
    if obs <= 0:
        return None
    return 100.0 * abs(c.get("predicted_time", 0.0) - obs) / obs
