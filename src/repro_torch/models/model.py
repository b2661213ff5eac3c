"""Public model API: init / weight import / the stateless forward /
prefill (whole, bucketed, chunked) / decode, and the fused decode +
prefill-chunk iteration; every entry point that allocates takes an
explicit ``device``.

Inputs per frontend (the modality frontends are stubs, as in the
reference: the caller provides precomputed embeddings):

  * ``none``   -- ``tokens`` (B, T)
  * ``audio``  -- ``embeds`` (B, T, d_model) frame embeddings (HuBERT)
  * ``vision`` -- ``patches`` (B, P, d_model) + ``tokens`` (B, T); the
                  patches form a bidirectional (prefix-LM) prefix ahead
                  of the text (PaliGemma).

The serving paths (bucketed and chunked prefill, decode) take token ids,
as the reference's engine does.  The decode step and the prefill chunk
take a ``graphs.StepGraphs``, which replays them where it holds a
capture (``capture_decode``, ``capture_chunk``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.graphs import Chain, StepGraphs
from repro_torch.models.kv_cache import StackState
from repro_torch.models.layers import embed, embed_init_, dense_init_, \
    rmsnorm, unembed
from repro_torch.models.transformer import HostIO, QKVOut
from repro_torch.tracing import span


class ModelParams(NamedTuple):
    embedding: Dict[str, torch.Tensor]
    blocks: Tuple[Any, ...]
    final_norm: Dict[str, torch.Tensor]


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: torch.device | str) -> ModelParams:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (the reference's ``jax.random`` weights cannot be regenerated in
    torch; ``params_from_numpy`` carries those across).  On the ``meta``
    device there is nothing to draw: see ``abstract_params``."""
    device = torch.device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    embedding = {"embed": embed_init_(
        torch.empty((cfg.vocab_size, d), dtype=dt, device=device), gen)}
    if not cfg.tie_embeddings:
        embedding["unembed"] = dense_init_(
            torch.empty((d, cfg.vocab_size), dtype=dt, device=device), gen)
    return ModelParams(
        embedding=embedding,
        blocks=transformer.stack_init(cfg, gen, device),
        final_norm={"scale": torch.ones((d,), dtype=dt, device=device)})


def abstract_params(cfg: ModelConfig) -> ModelParams:
    """The tree of ``init_params`` on the ``meta`` device: the same leaves,
    shapes and dtypes, nothing allocated (the dry-run's parameters)."""
    return init_params(cfg, device="meta")


def _leaf_to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    a = np.ascontiguousarray(a).reshape(a.shape)   # 0-d stays 0-d
    if not a.flags.writeable:               # torch wants writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":          # ml_dtypes: bit-exact via uint16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree_to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def params_from_numpy(cfg: ModelConfig, tree: Any,
                      device: torch.device | str) -> ModelParams:
    """Parameters from the reference ``ModelParams`` structure with numpy
    (or array-like) leaves: the ``embedding`` dict, ``blocks`` -- a tuple
    over pattern entries with leaves stacked (G, ...) -- and the
    ``final_norm`` dict.  Duck-typed: any object with those three
    attributes, holding dicts and tuples, works."""
    device = torch.device(device)
    params = ModelParams(
        embedding=_tree_to_torch(dict(tree.embedding), device),
        blocks=_tree_to_torch(tuple(tree.blocks), device),
        final_norm=_tree_to_torch(dict(tree.final_norm), device))
    if len(params.blocks) != cfg.pattern_period:
        raise ValueError(f"{len(params.blocks)} block entries for a pattern "
                         f"of period {cfg.pattern_period}")
    return params


def init_decode_state(cfg: ModelConfig, *, device_batch: int,
                      host_batch: int = 0, cache_len: int,
                      device: torch.device | str,
                      kv_dtype: torch.dtype = torch.bfloat16) -> StackState:
    """Zero decode state; recurrent entries also hold ``host_batch`` host
    rows (unified rows ``device_batch + i``)."""
    return transformer.state_init(cfg, device_batch=device_batch,
                                  host_batch=host_batch, cache_len=cache_len,
                                  device=torch.device(device),
                                  kv_dtype=kv_dtype)


def _logits(params: ModelParams, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    return unembed(params.embedding,
                   rmsnorm(params.final_norm, x, cfg.norm_eps))


def _embed_inputs(params: ModelParams, cfg: ModelConfig,
                  inputs: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x (B, T, d), prefix_len (B,) int32 or None) per the frontend."""
    compute = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "audio":
        return inputs["embeds"].to(compute), None
    if cfg.frontend == "vision":
        patches = inputs["patches"].to(compute)
        x = torch.cat([patches, embed(params.embedding, inputs["tokens"])],
                      dim=1)
        prefix = torch.full((x.shape[0],), patches.shape[1],
                            dtype=torch.int32, device=x.device)
        return x, prefix
    return embed(params.embedding, inputs["tokens"]), None


def _jitter_seed(rng: Optional[torch.Generator]) -> Optional[int]:
    """One draw from ``rng`` that seeds every layer's router jitter (the
    reference folds the layer index into its key); None without rng."""
    if rng is None:
        return None
    return int(torch.randint(0, 2 ** 62, (), generator=rng,
                             device=rng.device))


def forward_hidden(params: ModelParams, cfg: ModelConfig,
                   inputs: Dict[str, torch.Tensor], *,
                   rng: Optional[torch.Generator] = None,
                   remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stateless forward up to the final norm: (hidden (B, T, d), the
    summed MoE load-balance loss (0 without experts)).  Differentiable:
    autograd follows it through the kernels' backward kernels.  ``rng``
    draws the MoE router jitter (None: none); ``remat`` recomputes each
    pattern group in the backward."""
    x, prefix = _embed_inputs(params, cfg, inputs)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, t)
    x, aux = transformer.stack_forward_stateless(
        params.blocks, cfg, x, positions, prefix, remat=remat,
        seed=_jitter_seed(rng))
    return rmsnorm(params.final_norm, x, cfg.norm_eps), aux


def forward_train(params: ModelParams, cfg: ModelConfig,
                  inputs: Dict[str, torch.Tensor], *,
                  rng: Optional[torch.Generator] = None,
                  remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stateless forward of every position: (logits (B, T, V), aux
    loss).  The encoder's (``causal=False``) path; on the VLM, T counts
    the patches too."""
    x, aux = forward_hidden(params, cfg, inputs, rng=rng, remat=remat)
    return constrain(unembed(params.embedding, x), "batch", "seq",
                     "vocab"), aux


def prefill(params: ModelParams, cfg: ModelConfig,
            inputs: Dict[str, torch.Tensor], state: StackState
            ) -> Tuple[torch.Tensor, StackState]:
    """Process a prompt (``inputs`` per the frontend), filling ``state``
    in place: on the VLM the patches first, attended bidirectionally.
    Returns (last-position logits (B, V), new_state)."""
    x, prefix = _embed_inputs(params, cfg, inputs)
    t = x.shape[1]
    positions = state.lengths[:, None] + torch.arange(
        t, dtype=torch.int32, device=x.device)[None, :]
    x, new_state = transformer.stack_forward(params.blocks, cfg, x,
                                             positions, state,
                                             prefix_len=prefix)
    return _logits(params, cfg, x[:, -1]), new_state


def prefill_bucketed(params: ModelParams, cfg: ModelConfig,
                     tokens: torch.Tensor, prompt_lens: torch.Tensor, *,
                     cache_len: int,
                     kv_dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[torch.Tensor, StackState]:
    """Batched prefill over right-padded prompts (the serving fast path).

    tokens: (B, T) each row right-padded to the bucket length T;
    prompt_lens: (B,) real lengths on the same device.  Returns logits of
    each prompt's last real token and a fresh filled decode state.
    Exact: causal masking hides padded positions from every real one, and
    recurrent blocks freeze their state at ``prompt_lens[b]``.
    """
    b, t = tokens.shape
    state = init_decode_state(cfg, device_batch=b, cache_len=cache_len,
                              device=tokens.device, kv_dtype=kv_dtype)
    x = embed(params.embedding, tokens)
    positions = state.lengths[:, None] + torch.arange(
        t, dtype=torch.int32, device=tokens.device)[None, :]
    x, new_state = transformer.stack_forward(
        params.blocks, cfg, x, positions, state,
        valid_lens=prompt_lens.to(torch.int32))
    rows = torch.arange(b, device=tokens.device)
    x_last = x[rows, prompt_lens.long() - 1]
    return _logits(params, cfg, x_last), new_state


def _bound(params: ModelParams, state: StackState) -> Tuple[int, ...]:
    """What a captured step is bound to: the weights and the state's
    storage (its K/V caches and recurrent states are written in place)."""
    return (params.embedding["embed"].data_ptr(),) + tuple(
        t.data_ptr() for entry in state.per_entry for t in entry)


def _run(graphs: Optional[StepGraphs], name: str, params: ModelParams,
         state: StackState, build: Callable[[], Chain],
         inputs: Dict[str, torch.Tensor],
         outputs: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    graphs = graphs or StepGraphs()
    return graphs.run(name, _bound(params, state), build, inputs, outputs)


def _chunk_chain(params: ModelParams, cfg: ModelConfig,
                 state: StackState) -> Chain:
    def embed_span(io):
        x = embed(params.embedding, io["tokens"])
        io["x"] = x
        io["positions"] = io["lengths"][:, None] + torch.arange(
            x.shape[1], dtype=torch.int32, device=x.device)[None, :]
        io["valid_lens"] = io["chunk_lens"].to(torch.int32)

    def last_logits(io):
        x = io["x"]
        rows = torch.arange(x.shape[0], device=x.device)
        io["logits"] = _logits(params, cfg, x[
            rows, io["valid_lens"].long().clamp(min=1) - 1])

    chain = Chain()
    chain.add(embed_span)
    transformer.span_layers(chain, params.blocks, cfg, state)
    chain.add(last_logits)
    return chain


def prefill_chunk(params: ModelParams, cfg: ModelConfig,
                  tokens: torch.Tensor, chunk_lens: torch.Tensor,
                  state: StackState, graphs: Optional[StepGraphs] = None
                  ) -> Tuple[torch.Tensor, StackState]:
    """Advance a batch of in-progress prefills by one right-padded chunk.

    tokens: (B, C) -- row b's next ``chunk_lens[b]`` prompt tokens,
    right-padded to C (rows with ``chunk_lens`` 0 ride along idle);
    ``state`` is the staging state, whose ``lengths`` count each row's
    tokens already prefilled.  Queries run at absolute positions
    ``lengths + i`` against the accumulated K/V, so causality hides every
    padded or idle position; recurrent blocks resume their carried state
    and freeze at ``chunk_lens[b]``.  K/V and state are written in place.
    ``graphs`` replays the step where it holds a capture of it.

    Returns (logits (B, V) of each row's last real chunk token -- only
    meaningful for rows whose prompt completes in this chunk -- and the
    state with ``lengths`` advanced by ``chunk_lens``, not by C: junk K/V
    past a row's real chunk end lies beyond its length, in the causal
    future of every later query, and is overwritten as the row advances).
    """
    with span("model.chunk"):
        out = _run(graphs, "chunk", params, state,
                   lambda: _chunk_chain(params, cfg, state),
                   _chunk_inputs(tokens, chunk_lens, state), ("logits",))
        lens = chunk_lens.to(torch.int32)
        return out["logits"], StackState(
            per_entry=state.per_entry,
            lengths=state.lengths + lens.to(state.lengths.dtype))


def _chunk_inputs(tokens: torch.Tensor, chunk_lens: torch.Tensor,
                  state: StackState) -> Dict[str, torch.Tensor]:
    return {"tokens": tokens, "chunk_lens": chunk_lens,
            "lengths": state.lengths}


def decode_with_chunked_prefill(
        params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor,
        state: StackState, host: Optional[HostIO],
        chunk_tokens: torch.Tensor, chunk_lens: torch.Tensor,
        chunk_state: StackState,
        after_decode: Optional[Callable[[Optional[QKVOut]], None]] = None,
        graphs: Optional[StepGraphs] = None):
    """One engine iteration's device work: the unified decode step and one
    prefill chunk, enqueued back to back on the current stream.

    ``after_decode(qkv_out)`` runs on the host between the two, once the
    decode step is enqueued and before the chunk is: the engine records
    the event the host job waits on there and submits the job, so host
    attention overlaps the chunk's compute (the widened window of
    ASYNC_OVERLAP / ASYM_PIPELINE).

    Returns ``(logits, new_state, qkv_out, x_final, chunk_logits,
    new_chunk_state)`` -- the first four as ``decode_step``, the last two
    as ``prefill_chunk``.
    """
    logits, new_state, qkv_out, x_final = decode_step(
        params, cfg, tokens, state, host, graphs=graphs)
    if after_decode is not None:
        after_decode(qkv_out)
    chunk_logits, new_chunk = prefill_chunk(params, cfg, chunk_tokens,
                                            chunk_lens, chunk_state,
                                            graphs=graphs)
    return logits, new_state, qkv_out, x_final, chunk_logits, new_chunk


def _host_controls(cfg: ModelConfig, host: HostIO,
                   device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(transformer.host_controls(cfg, host))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _decode_inputs(cfg: ModelConfig, tokens: torch.Tensor,
                   state: StackState, host: Optional[HostIO]
                   ) -> Dict[str, torch.Tensor]:
    inputs = {"tokens": tokens, "lengths": state.lengths}
    if host is not None:
        inputs.update(x_carry=host.x_carry, host_positions=host.positions,
                      attn_in=host.attn_in, row_valid=host.row_valid,
                      controls=_host_controls(cfg, host,
                                              state.lengths.device))
    return inputs


def _decode_chain(params: ModelParams, cfg: ModelConfig, state: StackState,
                  host_rows: Optional[int]) -> Chain:
    def embed_rows(io):
        x = embed(params.embedding, io["tokens"])
        positions = io["lengths"]
        if host_rows is not None:
            x = torch.cat([x, io["x_carry"].to(x.dtype)], dim=0)
            positions = torch.cat([io["lengths"], io["host_positions"].to(
                io["lengths"].dtype)])
        io["x"] = x
        io["positions"] = positions

    def logits(io):
        io["logits"] = constrain(_logits(params, cfg, io["x"]), "batch",
                                 "vocab")

    chain = Chain()
    chain.add(embed_rows)
    transformer.decode_layers(chain, params.blocks, cfg, state, host_rows)
    chain.add(logits)
    return chain


def decode_step(params: ModelParams, cfg: ModelConfig,
                tokens: torch.Tensor, state: StackState,
                host: Optional[HostIO] = None,
                graphs: Optional[StepGraphs] = None
                ) -> Tuple[torch.Tensor, StackState, Optional[QKVOut],
                           torch.Tensor]:
    """One decode iteration.

    tokens: (Bg,) fresh tokens of the device rows; host rows ride along
    via ``host.x_carry``.  ``graphs`` replays the step where it holds a
    capture of it.  Returns (logits (B_total, V), new_state, qkv_out,
    x_final); ``x_final[Bg:]`` is the host rows' residual carry.
    """
    with span("model.decode"):
        host_rows = None if host is None else host.x_carry.shape[0]
        outputs = ("logits", "x")
        if host is not None:
            outputs += ("emit_q", "emit_k", "emit_v")
        out = _run(graphs, "decode", params, state,
                   lambda: _decode_chain(params, cfg, state, host_rows),
                   _decode_inputs(cfg, tokens, state, host), outputs)
        qkv_out = None
        if host is not None:
            qkv_out = QKVOut(q=out["emit_q"], k=out["emit_k"],
                             v=out["emit_v"])
        return out["logits"], StackState(
            per_entry=state.per_entry,
            lengths=state.lengths + 1), qkv_out, out["x"]


def capture_decode(params: ModelParams, cfg: ModelConfig,
                   graphs: StepGraphs, state: StackState,
                   host: Optional[HostIO] = None) -> None:
    """Capture ``decode_step`` on ``state``'s rows and ``host``'s (any
    phase: one capture serves them all).  The warm-up decodes token 0 in
    every device row, writing its K/V at the state's lengths: capture on
    a state whose rows hold nothing yet."""
    tokens = torch.zeros(state.lengths.shape, dtype=torch.int64,
                         device=state.lengths.device)
    host_rows = None if host is None else host.x_carry.shape[0]
    graphs.capture("decode", _bound(params, state),
                   _decode_chain(params, cfg, state, host_rows),
                   _decode_inputs(cfg, tokens, state, host))


def capture_chunk(params: ModelParams, cfg: ModelConfig, graphs: StepGraphs,
                  state: StackState, chunk_len: int) -> None:
    """Capture ``prefill_chunk`` on ``state``'s rows and chunks of
    ``chunk_len`` tokens.  The warm-up runs an idle chunk, writing K/V at
    the state's lengths: capture on a state whose rows hold nothing
    yet."""
    device = state.lengths.device
    rows = state.lengths.shape[0]
    graphs.capture("chunk", _bound(params, state),
                   _chunk_chain(params, cfg, state),
                   _chunk_inputs(torch.zeros((rows, chunk_len),
                                             dtype=torch.int64, device=device),
                                 torch.zeros((rows,), dtype=torch.int32,
                                             device=device), state))
