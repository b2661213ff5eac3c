"""Named spans on the profiler's timeline.

``span(name)`` marks a stretch of the serving path (``serve.*``) or of
the model (``model.*``).  While ``torch.profiler`` runs it is a
``record_function``, so the span lands on the profiler's own timeline,
the clock its CUDA events use; otherwise it is one shared no-op context,
so an untraced run pays a flag check per span.  There is nothing to
switch on: an operator traces the server by running ``torch.profiler``
around it.

Only the thread that started the profiler is recorded, so the host
tier's worker threads carry counters (``EngineStats``), not spans.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` while a profiler runs, else a shared
    no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
