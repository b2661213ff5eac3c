"""95th percentile, over every request with two or more tokens in the
window, of (last - first token time in the window) / (tokens - 1)."""
from portbench.harness import timeline


def read(rec):
    v = timeline.percentile(timeline.tpots(rec["requests"], rec["t_open"],
                                           rec["t_close"]), 95)
    return None if v is None else 1e3 * v
