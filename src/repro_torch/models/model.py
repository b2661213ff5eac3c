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
as the reference's engine does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
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


def prefill_chunk(params: ModelParams, cfg: ModelConfig,
                  tokens: torch.Tensor, chunk_lens: torch.Tensor,
                  state: StackState) -> Tuple[torch.Tensor, StackState]:
    """Advance a batch of in-progress prefills by one right-padded chunk.

    tokens: (B, C) -- row b's next ``chunk_lens[b]`` prompt tokens,
    right-padded to C (rows with ``chunk_lens`` 0 ride along idle);
    ``state`` is the staging state, whose ``lengths`` count each row's
    tokens already prefilled.  Queries run at absolute positions
    ``lengths + i`` against the accumulated K/V, so causality hides every
    padded or idle position; recurrent blocks resume their carried state
    and freeze at ``chunk_lens[b]``.  K/V and state are written in place.

    Returns (logits (B, V) of each row's last real chunk token -- only
    meaningful for rows whose prompt completes in this chunk -- and the
    state with ``lengths`` advanced by ``chunk_lens``, not by C: junk K/V
    past a row's real chunk end lies beyond its length, in the causal
    future of every later query, and is overwritten as the row advances).
    """
    with span("model.chunk"):
        b, c = tokens.shape
        x = embed(params.embedding, tokens)
        positions = state.lengths[:, None] + torch.arange(
            c, dtype=torch.int32, device=tokens.device)[None, :]
        lens = chunk_lens.to(torch.int32)
        x, new_state = transformer.stack_forward(params.blocks, cfg, x,
                                                 positions, state,
                                                 valid_lens=lens)
        rows = torch.arange(b, device=tokens.device)
        x_last = x[rows, lens.long().clamp(min=1) - 1]
        return _logits(params, cfg, x_last), StackState(
            per_entry=new_state.per_entry,
            lengths=state.lengths + lens.to(state.lengths.dtype))


def decode_with_chunked_prefill(
        params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor,
        state: StackState, host: Optional[HostIO],
        chunk_tokens: torch.Tensor, chunk_lens: torch.Tensor,
        chunk_state: StackState,
        after_decode: Optional[Callable[[Optional[QKVOut]], None]] = None):
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
    logits, new_state, qkv_out, x_final = decode_step(params, cfg, tokens,
                                                      state, host)
    if after_decode is not None:
        after_decode(qkv_out)
    chunk_logits, new_chunk = prefill_chunk(params, cfg, chunk_tokens,
                                            chunk_lens, chunk_state)
    return logits, new_state, qkv_out, x_final, chunk_logits, new_chunk


def decode_step(params: ModelParams, cfg: ModelConfig,
                tokens: torch.Tensor, state: StackState,
                host: Optional[HostIO] = None
                ) -> Tuple[torch.Tensor, StackState, Optional[QKVOut],
                           torch.Tensor]:
    """One decode iteration.

    tokens: (Bg,) fresh tokens of the device rows; host rows ride along
    via ``host.x_carry``.  Returns (logits (B_total, V), new_state,
    qkv_out, x_final); ``x_final[Bg:]`` is the host rows' residual carry.
    """
    with span("model.decode"):
        x = embed(params.embedding, tokens)
        positions = state.lengths
        if host is not None:
            x = torch.cat([x, host.x_carry.to(x.dtype)], dim=0)
            positions = torch.cat([state.lengths,
                                   host.positions.to(state.lengths.dtype)])
        x, new_state, qkv_out = transformer.decode_step(
            params.blocks, cfg, x, positions, state, host)
        logits = constrain(_logits(params, cfg, x), "batch", "vocab")
        return logits, new_state, qkv_out, x
