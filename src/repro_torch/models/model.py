"""Public model API: init / weight import / prefill / decode.

Causal stacks of attention and Mamba blocks with dense FFNs and token
inputs; every entry point takes an explicit ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import StackState
from repro_torch.models.layers import embed, embed_init_, dense_init_, \
    rmsnorm, unembed
from repro_torch.models.transformer import HostIO, QKVOut


class ModelParams(NamedTuple):
    embedding: Dict[str, torch.Tensor]
    blocks: Tuple[Any, ...]
    final_norm: Dict[str, torch.Tensor]


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: torch.device | str) -> ModelParams:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (the reference's ``jax.random`` weights cannot be regenerated in
    torch; ``params_from_numpy`` carries those across)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
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


def _leaf_to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
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


def prefill(params: ModelParams, cfg: ModelConfig,
            inputs: Dict[str, torch.Tensor], state: StackState
            ) -> Tuple[torch.Tensor, StackState]:
    """Process a prompt ``inputs["tokens"]`` (B, T), filling ``state``
    in place.  Returns (last-token logits (B, V), new_state)."""
    tokens = inputs["tokens"]
    x = embed(params.embedding, tokens)
    t = tokens.shape[1]
    positions = state.lengths[:, None] + torch.arange(
        t, dtype=torch.int32, device=tokens.device)[None, :]
    x, new_state = transformer.stack_forward(params.blocks, cfg, x,
                                             positions, state)
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
    Mamba blocks freeze their state at ``prompt_lens[b]``.
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
    x = embed(params.embedding, tokens)
    positions = state.lengths
    if host is not None:
        x = torch.cat([x, host.x_carry.to(x.dtype)], dim=0)
        positions = torch.cat([state.lengths,
                               host.positions.to(state.lengths.dtype)])
    x, new_state, qkv_out = transformer.decode_step(
        params.blocks, cfg, x, positions, state, host)
    return _logits(params, cfg, x), new_state, qkv_out, x
