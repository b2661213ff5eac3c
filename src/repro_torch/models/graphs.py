"""The model step cut at its attention calls, and CUDA graphs of the
pieces between them.

A ``Chain`` is one step (the unified decode step, a prefill chunk, a
prefill) written as pieces and attention calls in turn: piece 0,
attention 0, piece 1, ..., attention n-1, piece n.  A piece is a list of
ops that read and write the step's named tensors (``io``); an attention
call reads them and returns the attention output, which the next piece
reads as ``io["attn"]``.  Run eagerly, the chain is the step.

Each piece has fixed shapes and reads nothing back to the host, so a
``ChainGraph`` captures it as a CUDA graph and replays it.  The
attention calls stay eager, one Python call per layer through
``kernels.ops`` (looked up at call time), so whatever wraps those entry
points sees every call with its shapes and lengths.  Around the
replays, every tensor a piece leaves in ``io`` lives in a buffer of its
own (allocated outside the graph pool at the warm-up, copied there
inside the graph), inputs are copied into static buffers before the
first replay, and each attention output is copied into the buffer the
next piece reads.

``StepGraphs`` holds one engine's captures, one per step and input
shapes, and runs a step by replay where one was captured, else eagerly.
Captures are serialised across the process and use thread-local capture
mode (another engine's thread may launch meanwhile).  All graphs of a
device share one memory pool, which holds only the pieces' temporaries:
two engines' graphs may be handed the same pool memory, so no two
replays may overlap.  Every replay runs on the device's default stream,
where launches from every thread run one after another; ``StepGraphs``
refuses a replay on any other stream.  A capture that fails (an op the
graph cannot hold) raises: the caching allocator keeps routing the
failed capture's pool, so that pool would refuse every later capture.
"""
from __future__ import annotations

import threading
from typing import (Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.models.config import BlockKind, FFNKind, ModelConfig

IO = Dict[str, torch.Tensor]
Op = Callable[[IO], None]
Attend = Callable[[IO], torch.Tensor]

_CAPTURE_LOCK = threading.Lock()
# device -> (graph pool, capture stream, the graph that keeps the pool)
_POOLS: Dict[int, Tuple[object, object, object]] = {}


class Chain:
    """A step as ``ops[0], attends[0], ops[1], ..., ops[-1]``: ops are
    appended to the current piece, ``cut`` closes it at an attention
    call."""

    def __init__(self) -> None:
        self.ops: List[List[Op]] = [[]]
        self.attends: List[Attend] = []

    def add(self, op: Op) -> None:
        self.ops[-1].append(op)

    def cut(self, attend: Attend) -> None:
        self.attends.append(attend)
        self.ops.append([])

    def run(self, io: IO) -> IO:
        """The step, eagerly: ``io`` holds the inputs and gets the
        outputs."""
        for i, ops in enumerate(self.ops):
            for op in ops:
                op(io)
            if i < len(self.attends):
                io["attn"] = self.attends[i](io)
        return io


def capturable(cfg: ModelConfig) -> bool:
    """Whether the step's pieces may be captured: every pattern entry is
    attention with a dense FFN or none.  An MoE routes by the data (its
    expert loop reads counts back) and a recurrent entry runs its own
    kernels with state handled apart; their steps run eagerly."""
    return all(kind == BlockKind.ATTN
               and cfg.ffn_kind_for_entry(j) != FFNKind.MOE
               for j, kind in enumerate(cfg.block_pattern))


def cuda_capture(piece: Callable[[], None], *, pool, stream
                 ) -> Callable[[], None]:
    """``piece`` captured as a CUDA graph on ``stream`` into ``pool``;
    returns its replay."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            piece()
        finally:
            g.capture_end()
    return g.replay


class ChainGraph:
    """A chain at one set of input shapes, each piece captured once.

    Built by running the chain once eagerly on ``inputs`` (the warm-up:
    every kernel loaded, every buffer made), then capturing each piece
    with ``capture`` (``cuda_capture``, or in a test a stand-in that
    replays a piece by running it)."""

    def __init__(self, chain: Chain, inputs: IO,
                 capture: Callable[[Callable[[], None]],
                                   Callable[[], None]]) -> None:
        self.chain = chain
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.io: IO = dict(self.inputs)
        self.buffers: IO = {}
        self.attn: Optional[torch.Tensor] = None
        pieces = [lambda ops=ops: self._piece(ops) for ops in chain.ops]
        for i, piece in enumerate(pieces):
            piece()
            self._attend(i)
        self.launches = [capture(piece) for piece in pieces]

    def _piece(self, ops: List[Op]) -> None:
        """Run a piece's ops and move what they left in ``io`` into
        buffers of its own (the copies are part of the captured graph)."""
        io = self.io
        before = dict(io)
        for op in ops:
            op(io)
        for k, v in list(io.items()):
            if v is before.get(k):
                continue
            buf = self.buffers.get(k)
            if buf is None:
                buf = self.buffers[k] = torch.empty_like(v)
            buf.copy_(v)
            io[k] = buf

    def _attend(self, i: int) -> None:
        if i >= len(self.chain.attends):
            return
        out = self.chain.attends[i](self.io)
        if self.attn is None:           # every layer's output is one shape
            self.attn = self.io["attn"] = torch.empty_like(out)
        self.attn.copy_(out)

    def replay(self, inputs: IO) -> IO:
        """The step on ``inputs`` (the captured shapes): returns ``io``,
        whose tensors the next replay overwrites."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        for i, launch in enumerate(self.launches):
            launch()
            self._attend(i)
        return self.io


def signature(inputs: IO) -> Tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())


class StepGraphs:
    """One engine's steps: captured ones keyed by the step's name, what
    it is bound to (weights and state storage) and its inputs' shapes,
    and the last chain built for each step and shapes, rebuilt when its
    binding changes.  ``capture`` None: nothing is captured and every
    step runs eagerly.  ``steps`` counts the steps run, ``replays`` those
    served by replay."""

    def __init__(self, capture: Optional[Callable[[Callable[[], None]],
                                                  Callable[[], None]]] = None,
                 device: Optional[torch.device] = None) -> None:
        self._capture = capture
        self._device = device           # CUDA: replays on its default stream
        self._graphs: Dict[Hashable, ChainGraph] = {}
        self._chains: Dict[Hashable, Tuple[Hashable, Chain]] = {}
        self.steps = 0
        self.replays = 0

    @classmethod
    def for_device(cls, cfg: ModelConfig, device: torch.device
                   ) -> "StepGraphs":
        """Captures on a CUDA device where ``capturable(cfg)``: the pool
        and the capture stream are the device's, shared by its engines."""
        if device.type != "cuda" or not capturable(cfg):
            return cls()
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        with _CAPTURE_LOCK:
            if idx not in _POOLS:
                with torch.cuda.device(idx):
                    pool = torch.cuda.graph_pool_handle()
                    stream = torch.cuda.Stream(idx)
                    # a pool dies with the last graph captured into it, so
                    # one small graph that lives as long as the process
                    # keeps it for every engine to come
                    def fill():
                        torch.zeros(1, device=device)
                    fill()
                    keeper = cuda_capture(fill, pool=pool, stream=stream)
                _POOLS[idx] = (pool, stream, keeper)
        pool, stream, _ = _POOLS[idx]

        def capture(piece):
            return cuda_capture(piece, pool=pool, stream=stream)
        return cls(capture, torch.device("cuda", idx))

    @property
    def captures(self) -> bool:
        return self._capture is not None

    def capture(self, name: str, bound: Hashable, chain: Chain,
                inputs: IO) -> None:
        """Capture ``chain`` at ``inputs``' shapes.  The warm-up runs the
        step once on ``inputs``, writing its K/V at their positions."""
        with _CAPTURE_LOCK:
            self._graphs[(name, bound, signature(inputs))] = ChainGraph(
                chain, inputs, self._capture)

    def run(self, name: str, bound: Hashable, build: Callable[[], Chain],
            inputs: IO, outputs: Sequence[str]) -> IO:
        """The step: replayed where it was captured bound to ``bound`` at
        these shapes (the outputs cloned, since the next replay
        overwrites them), else its chain run eagerly."""
        self.steps += 1
        sig = signature(inputs)
        graph = self._graphs.get((name, bound, sig))
        if graph is None:
            last = self._chains.get((name, sig))
            if last is None or last[0] != bound:
                last = self._chains[(name, sig)] = (bound, build())
            io = last[1].run(dict(inputs))
            return {k: io[k] for k in outputs}
        if self._device is not None:
            stream = torch.cuda.current_stream(self._device)
            if stream != torch.cuda.default_stream(self._device):
                raise RuntimeError(
                    f"a step graph replays on the default stream only, not "
                    f"on {stream}: the graphs of a device share one pool")
        self.replays += 1
        io = graph.replay(inputs)
        return {k: io[k].clone() for k in outputs}
