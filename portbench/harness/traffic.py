"""One general generator of traffic from a mix's parameters
(``traffic/<mix>.json``).

A mix describes sessions.  Each session is an optional system prefix
shared by every session of the run, then ``turns`` turns; a turn's prompt
is the prefix, the conversation so far (earlier user texts and the
replies the server actually gave) and a new user text, and its reply is
``max_new_tokens`` long.  The next turn is due ``think_s`` after the
reply's last token.  The loop is closed (a fixed number of clients, each
starting its next session when the last ended) or open (sessions due on
a Poisson schedule at ``rate_per_s``).

Lengths are lognormal with a stated mean and coefficient of variation
(the shapes of ``repro_torch/serving/workloads.py`` at commit 33acfed:
Azure conversation prompts mean 1020 cv 1.2, outputs 210 cv 0.8;
LiveBench prompts 1800 cv 0.7), rounded and clipped.  Every seed gets
the same multiset of lengths and inter-arrival gaps -- the quantiles of
the distribution at ``POOL`` evenly spaced probabilities -- in an order
and with token ids drawn from the seed, so seeds change which request
comes when, not how much work a run holds.  The order is stratified in
blocks of ``BLOCK``: every block of consecutive draws holds
one value of each eighth of the distribution, so any stretch of the run
carries about the same work and the same number of arrivals.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np

BLOCK = 8       # draws a stratified block holds: one from each eighth
POOL = 1024     # quantiles drawn of each distribution, a multiple of BLOCK


def quantile_pool(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the distribution's quantiles (i + 0.5) / n."""
    mean, cv = float(dist["mean"]), float(dist["cv"])
    sigma2 = math.log(1.0 + cv * cv)
    mu = math.log(mean) - sigma2 / 2.0
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(mu + math.sqrt(sigma2) * z)
    return np.clip(np.round(x).astype(np.int64), int(dist["min"]),
                   int(dist["max"]))


def stratified(values: np.ndarray, block: int,
               rng: np.random.Generator) -> np.ndarray:
    """The values in an order drawn from ``rng`` in which each run of
    ``block`` consecutive values (from the start) holds one value of
    each of ``block`` strata of the sorted values, so every block carries
    about the same total; the order within blocks and of the blocks is
    random.  The multiset is unchanged (its size a multiple of
    ``block``)."""
    v = np.sort(np.asarray(values))
    nb = len(v) // block
    if nb * block != len(v):
        raise ValueError(f"{len(v)} values do not fill blocks of {block}")
    strata = v.reshape(block, nb).copy()
    for row in strata:
        rng.shuffle(row)
    blocks = strata.T.copy()
    for b in blocks:
        rng.shuffle(b)
    rng.shuffle(blocks)
    return blocks.reshape(-1)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` inter-arrival gaps of a Poisson process at ``rate`` per
    second, at the exponential's quantiles."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / rate


def resolve_caps(mix: dict, cache_len: int) -> dict:
    """The mix with a prompt cap of ``"fit"`` replaced by the largest
    prompt that leaves room for the longest reply in ``cache_len`` (the
    engine refuses a prompt of ``cache_len - 1`` or more)."""
    mix = dict(mix)
    for key in ("user", "reply"):
        mix[key] = dict(mix[key])
    if mix["user"]["max"] == "fit":
        mix["user"]["max"] = cache_len - int(mix["reply"]["max"]) - 1
    longest = (int(mix.get("shared_prefix", 0))
               + int(mix["turns"]) * (int(mix["user"]["max"])
                                      + int(mix["reply"]["max"])))
    if longest > cache_len - 1:
        raise ValueError(f"mix's longest session ({longest} tokens) does not "
                         f"fit cache_len {cache_len}")
    return mix


def clients(mix: dict, engine: dict) -> int:
    """Clients of a closed loop: the sum of the engine settings named by
    ``clients_from`` (as many as the slots they fill)."""
    return sum(int(engine[k]) for k in mix["clients_from"])


@dataclasses.dataclass
class Session:
    sid: int
    users: List[List[int]]        # one user text per turn
    replies: List[int]            # max_new_tokens of each turn
    arrival: Optional[float]      # open loop: offset from the window's
    # schedule start; closed loop: None


class Traffic:
    """Sessions drawn from the seed: ``session(i)`` is the i-th session,
    the same for every call with the same seed."""

    def __init__(self, mix: dict, *, seed: int, vocab: int,
                 cache_len: int) -> None:
        self.mix = resolve_caps(mix, cache_len)
        self.seed = int(seed) % (1 << 63)
        self.vocab = int(vocab)
        pool = POOL
        block = BLOCK
        rng = np.random.default_rng([self.seed, 0x5E55])
        self._users = stratified(quantile_pool(self.mix["user"], pool),
                                 block, rng)
        self._replies = stratified(quantile_pool(self.mix["reply"], pool),
                                   block, rng)
        self._gaps = None
        if self.mix["loop"] == "open":
            self._gaps = stratified(
                exp_gaps(float(self.mix["rate_per_s"]), pool), block, rng)
        self._pool = pool
        self.prefix = [int(t) for t in np.random.default_rng(
            [self.seed, 0x9F1]).integers(0, vocab,
                                         int(self.mix.get("shared_prefix",
                                                          0)))]
        self._arrivals: List[float] = []

    def _draw(self, arr: np.ndarray, k: int) -> int:
        return int(arr[k % self._pool])

    def arrival(self, i: int) -> float:
        """Open loop: session i's due offset (seconds) from the start of
        the schedule."""
        k = len(self._arrivals)
        while k <= i:
            self._arrivals.append(0.0 if k == 0 else self._arrivals[k - 1]
                                  + float(self._gaps[(k - 1) % self._pool]))
            k += 1
        return self._arrivals[i]

    def session(self, i: int) -> Session:
        turns = int(self.mix["turns"])
        rng = np.random.default_rng([self.seed, 0x70C, i])
        users, replies = [], []
        for j in range(turns):
            k = i * turns + j
            n = self._draw(self._users, k)
            users.append([int(t) for t in rng.integers(0, self.vocab, n)])
            replies.append(self._draw(self._replies, k))
        arrival = self.arrival(i) if self.mix["loop"] == "open" else None
        return Session(i, users, replies, arrival)

    def prompt(self, s: Session, turn: int, history: List[List[int]]
               ) -> List[int]:
        """Turn ``turn``'s prompt: the shared prefix, then each earlier
        turn's user text and the reply served to it, then this turn's
        user text."""
        out = list(self.prefix)
        for j in range(turn):
            out += s.users[j] + history[j]
        return out + s.users[turn]
