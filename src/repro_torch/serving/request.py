"""Request lifecycle for the online serving engine.

``arrival_time`` semantics: ``None`` means "not yet arrived" — the
engine stamps ``time.perf_counter()`` at ``submit()``.  Workload
generators (``repro_torch.serving.workloads``) instead fill *relative*
offsets from trace start; ``InferenceServer.serve`` rebases those onto
the wall clock before submission.  Latency accessors return ``None``
rather than silently mixing the two clocks.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

import numpy as np

_ids = itertools.count()


class Phase(str, enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE_DEVICE = "decode_device"
    DECODE_HOST = "decode_host"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    arrival_time: Optional[float] = None
    phase: Phase = Phase.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    # serving bookkeeping
    slot: Optional[int] = None          # device cache slot (device tier)
    tier: Optional[str] = None          # "device" | "host" once admitted
    kv_reserved: int = 0                # tokens held in the admission budget
    layer_progress: int = 0             # APEX rule-4 partial progress
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # rejection reason: set when the request is refused at submit or
    # admission (e.g. prompt too long for the KV cache); the request
    # finishes in Phase.FINISHED with failed=True and no output
    error: Optional[str] = None
    # --- admission order --------------------------------------------
    # TTFT deadline in seconds relative to arrival (None = none): orders
    # the admission queue earliest-due first within a priority class
    deadline: Optional[float] = None
    # admission priority (higher = more urgent): orders the queue first
    priority: int = 0

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def tokens_generated(self) -> int:
        return len(self.output)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.tokens_generated

    @property
    def done(self) -> bool:
        # a rejected request is finished work too — without the failed
        # clause a `while not req.done: engine.step()` loop would spin
        # forever on a request that was refused at admission
        return self.failed or self.tokens_generated >= self.max_new_tokens

    def kv_demand(self) -> int:
        """Tokens of KV this request will need in total."""
        return self.prompt_len + self.max_new_tokens

    def per_token_latency(self) -> Optional[float]:
        if self.finish_time is None or self.arrival_time is None \
                or not self.output:
            return None
        return (self.finish_time - self.arrival_time) / len(self.output)

    def time_to_first_token(self) -> Optional[float]:
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time


def make_synthetic_request(rng: np.random.Generator, *, prompt_len: int,
                           output_len: int, vocab: int,
                           arrival: Optional[float] = None,
                           deadline: Optional[float] = None,
                           priority: int = 0) -> Request:
    return Request(
        prompt=list(rng.integers(0, vocab, prompt_len)),
        max_new_tokens=output_len, arrival_time=arrival,
        deadline=deadline, priority=priority)
