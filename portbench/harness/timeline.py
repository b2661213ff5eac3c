"""End-to-end arithmetic over the client's timeline of one window.

Every request is a ``(due, token_times)`` pair on the host clock: when
it was due to be sent, and when the client saw each of its tokens.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

Timeline = Tuple[float, Sequence[float]]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it; None for no values."""
    if not values:
        return None
    s = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[rank - 1]


def ttfts(requests: Iterable[Timeline], t_open: float, t_close: float
          ) -> List[float]:
    """Time to first token of every request due in [t_open, t_close),
    from its due time; one with no token by the close counts at its
    elapsed time then (so a stall shows)."""
    out = []
    for due, times in requests:
        if not t_open <= due < t_close:
            continue
        first = times[0] if times and times[0] <= t_close else None
        out.append((first if first is not None else t_close) - due)
    return out


def tpots(requests: Iterable[Timeline], t_open: float, t_close: float
          ) -> List[float]:
    """Of every request with two or more tokens in (t_open, t_close]:
    (last - first token time in the window) / (tokens - 1)."""
    out = []
    for _, times in requests:
        inside = [t for t in times if t_open < t <= t_close]
        if len(inside) >= 2:
            out.append((inside[-1] - inside[0]) / (len(inside) - 1))
    return out


def tokens_in(requests: Iterable[Timeline], t_open: float,
              t_close: float) -> int:
    """Output tokens the client saw in (t_open, t_close], first tokens
    included."""
    return sum(sum(1 for t in times if t_open < t <= t_close)
               for _, times in requests)


def counter_delta(before: dict, after: dict) -> dict:
    """after - before for every numeric counter (dicts of counts, such as
    the strategy counts, key by key)."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, bool) or v is None:
            continue
        if isinstance(v, (int, float)):
            out[k] = v - (b or 0)
        elif isinstance(v, dict):
            out[k] = {kk: vv - (b or {}).get(kk, 0) for kk, vv in v.items()
                      if isinstance(vv, (int, float))}
    return out
