"""ttft_p95_ms as a per-layer reading, for closed-loop cells whose tail
over a window's few dozen requests spreads too far between runs to hold
an end-to-end bound: the same definition (95th percentile over every
request due in the window, censored at the close)."""
from portbench.harness import timeline


def read(rec):
    v = timeline.percentile(timeline.ttfts(rec["requests"], rec["t_open"],
                                           rec["t_close"]), 95)
    return None if v is None else 1e3 * v
