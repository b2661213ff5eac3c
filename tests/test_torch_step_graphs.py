"""The model step cut at its attention calls (``models.graphs``), on the
CPU.

The card replays each piece as a CUDA graph (tests/test_torch_cuda.py).
Here a stand-in capture replays a piece by running it, so everything
around the graphs runs as on the card: inputs copied into static
buffers, every tensor a piece leaves in ``io`` copied into a buffer of
its own, attention outputs copied into the buffer the next piece reads,
the host rows' layer fields fed as data, and one capture per shape
serving every phase of a cohort.  That path is held bit for bit to a
plain decode step written below as one loop with the layer fields as
host ints.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch.configs import get_config
from repro_torch.core.overlap_engine import Cohort, OverlapController
from repro_torch.kernels import ops
from repro_torch.models import (HostIO, StepGraphs, capture_decode,
                                decode_step, init_decode_state, init_params,
                                prefill)
from repro_torch.models.config import BlockKind, FFNKind
from repro_torch.models.graphs import capturable
from repro_torch.models.layers import (attention_output, embed, qkv_project,
                                       rmsnorm, rope_frequencies, unembed)
from repro_torch.models.transformer import (_ffn, _mamba_block, _xlstm_block,
                                            layer_params)
from repro_torch.serving import Engine, EngineConfig, Request


def stand_in(piece):
    """A capture that replays a piece by running it."""
    return piece


def reference_decode(params, cfg, tokens, state, host):
    """One decode step as one loop over the layers, the host rows' layer
    fields read as host ints: (logits, qkv_out, x_final)."""
    x = embed(params.embedding, tokens)
    positions = state.lengths
    bg = state.lengths.shape[0]
    if host is not None:
        x = torch.cat([x, host.x_carry.to(x.dtype)], dim=0)
        positions = torch.cat([state.lengths,
                               host.positions.to(state.lengths.dtype)])
    bc = x.shape[0] - bg
    hd = cfg.resolved_head_dim
    inv_freq = rope_frequencies(hd, cfg.rope_theta, x.device)
    rows = torch.arange(bg)
    lengths = state.lengths.long()
    qkv = None
    if host is not None:
        qkv = (torch.zeros((bc, cfg.num_heads, hd)),
               torch.zeros((bc, cfg.num_kv_heads, hd)),
               torch.zeros((bc, cfg.num_kv_heads, hd)))
        ones = torch.ones((bg,), dtype=torch.int32)
        commit_in = torch.cat([ones, host.row_valid.int()])
        commit_out = torch.cat([ones, torch.zeros((bc,), dtype=torch.int32)])
    for g in range(cfg.num_groups):
        for j, kind in enumerate(cfg.block_pattern):
            layer = g * cfg.pattern_period + j
            in_window = host is not None and \
                host.window_start <= layer < host.window_end
            p = layer_params(params.blocks, j, g)
            entry = state.per_entry[j]
            if kind == BlockKind.ATTN:
                h = rmsnorm(p["ln1"], x, cfg.norm_eps)[:, None]
                q, k, v = qkv_project(p["attn"], h, cfg.num_heads,
                                      cfg.num_kv_heads, hd,
                                      positions[:, None], inv_freq)
                kc, vc = entry.k[g], entry.v[g]
                kc[rows, lengths] = k[:bg, 0].to(kc.dtype)
                vc[rows, lengths] = v[:bg, 0].to(vc.dtype)
                attn = ops.decode_attention(q[:bg, 0], kc, vc,
                                            (lengths + 1).int())
                if host is not None:
                    attn_c = (host.attn_in.to(attn.dtype)
                              if layer == host.consume_layer else
                              torch.zeros((bc,) + attn.shape[1:],
                                          dtype=attn.dtype))
                    attn = torch.cat([attn, attn_c], dim=0)
                    if layer == host.emit_layer:
                        qkv = (q[bg:, 0].float(), k[bg:, 0].float(),
                               v[bg:, 0].float())
                x_new = x + attention_output(p["attn"], attn[:, None])[:, 0]
                x_new = _ffn(p, cfg, x_new[:, None])[:, 0]
            else:
                lens = None
                if host is not None:
                    lens = commit_in if in_window else commit_out
                if kind == BlockKind.MAMBA:
                    x_new = _mamba_block(p, cfg, x[:, None], entry, g, lens)
                else:
                    x_new = _xlstm_block(p, cfg, kind, x[:, None], entry, g,
                                         lens)
                x_new = x_new[:, 0]
            if host is None:
                x = x_new
                continue
            host_rows = x[bg:]
            if in_window:
                host_rows = torch.where(host.row_valid[:, None],
                                        x_new[bg:], x[bg:])
            x = torch.cat([x_new[:bg], host_rows], dim=0)
    logits = unembed(params.embedding,
                     rmsnorm(params.final_norm, x, cfg.norm_eps))
    return logits, qkv, x


def _tensors(state):
    return [t for entry in state.per_entry for t in entry] + [state.lengths]


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def _zero_host(cfg, bc, dtype):
    return HostIO(x_carry=torch.zeros((bc, cfg.d_model), dtype=dtype),
                  positions=torch.zeros((bc,), dtype=torch.int32),
                  attn_in=torch.zeros((bc, cfg.num_heads,
                                       cfg.resolved_head_dim)),
                  consume_layer=-1, emit_layer=-1, window_start=0,
                  window_end=0, row_valid=torch.zeros((bc,), dtype=torch.bool))


CONFIGS = {
    "internlm2-1.8b": dict(layers=4),
    "internlm2-1.8b-fp32": dict(layers=4),
    "jamba-1.5-large-398b": dict(layers=16),
}


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_static_buffer_decode_matches_plain_step_through_a_journey(arch):
    """Device-only decode, then a host cohort through its journey (the
    first emit, every consume with the next emit, the late-poll idle
    HostIO in the middle, the last consume), each step served by the
    captures of two shapes: x_final, K/V (and recurrent state), emitted
    Q/K/V and logits bitwise those of the plain step."""
    cfg = get_config(arch.removesuffix("-fp32")).reduced(
        d_model=64, vocab=96, **CONFIGS[arch])
    if arch.endswith("-fp32"):
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    dtype = params.embedding["embed"].dtype
    bg, bc, cache = 2, 3, 48
    state = init_decode_state(cfg, device_batch=bg, host_batch=bc,
                              cache_len=cache, device="cpu")
    fresh = [t.clone() for t in _tensors(state)]
    graphs = StepGraphs(stand_in)
    if not cfg.has_recurrent:     # a hybrid's recurrent state spans them
        capture_decode(params, cfg, graphs, state)
    capture_decode(params, cfg, graphs, state, _zero_host(cfg, bc, dtype))
    for t, f in zip(_tensors(state), fresh):    # the warm-ups' writes
        t.copy_(f)
    # the device rows prefilled on a state of their own, then lifted in;
    # host rows' recurrent state random
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (bg, 7)))
    pre = init_decode_state(cfg, device_batch=bg, cache_len=cache,
                            device="cpu")
    logits, pre = prefill(params, cfg, {"tokens": prompt}, pre)
    for big, small in zip(_tensors(state), _tensors(pre)):
        if big.shape == small.shape:
            big.copy_(small)
            continue
        big[:, :bg].copy_(small)
        big[:, bg:].copy_(0.5 * torch.randn(big[:, bg:].shape,
                                            generator=gen))
    ref_state = type(state)(per_entry=tuple(
        type(e)(*(t.clone() for t in e)) for e in state.per_entry),
        lengths=state.lengths.clone())

    ctl = OverlapController(cfg)
    cohort = Cohort(slot_rids=[4, -1, 6],
                    positions=np.array([11, 0, 5], np.int64),
                    x_carry=torch.from_numpy(rng.standard_normal(
                        (bc, cfg.d_model)).astype(np.float32)).to(dtype),
                    attn_in=torch.zeros((bc, cfg.num_heads,
                                         cfg.resolved_head_dim)))
    phases = [] if cfg.has_recurrent else [None]
    for i in range(ctl.iterations_per_token):
        phases.append(ctl.host_io(cohort))
        if i == 1:
            phases.append(phases[-1]._replace(
                consume_layer=-1, emit_layer=-1, window_start=0,
                window_end=0))
        ctl.advance(cohort)
    assert cohort.attn_ptr == -1
    tokens = logits.argmax(-1)
    seen = set()
    for host in phases:
        if host is not None:
            host = host._replace(attn_in=torch.from_numpy(
                rng.standard_normal(tuple(host.attn_in.shape)).astype(
                    np.float32)))
            seen.add((host.consume_layer >= 0, host.emit_layer >= 0,
                      host.window_end > host.window_start))
        want, want_qkv, want_x = reference_decode(params, cfg, tokens,
                                                  ref_state, host)
        ref_state = type(ref_state)(per_entry=ref_state.per_entry,
                                    lengths=ref_state.lengths + 1)
        got, state, qkv, x = decode_step(params, cfg, tokens, state, host,
                                         graphs=graphs)
        assert _equal(got, want) and _equal(x, want_x)
        if host is None:
            assert qkv is None and want_qkv is None
        else:
            assert all(_equal(a, b) for a, b in zip(qkv, want_qkv))
            cohort.x_carry = x[bg:]
        for a, b in zip(_tensors(state), _tensors(ref_state)):
            assert _equal(a, b)
        tokens = got[:bg].argmax(-1)
    # (consume, emit, a commit window): the first emit, consumes with the
    # next emit, the late poll, the last consume (the window's exit)
    first = (False, True, cfg.attn_layer_indices[0] > 0)
    assert seen == {first, (True, True, True), (False, False, False),
                    (True, False, True)}
    assert graphs.replays == graphs.steps == len(phases)


@pytest.mark.parametrize("arch,want", [
    ("internlm2-1.8b", True), ("llama3.1-8b", True), ("stablelm-12b", True),
    ("deepseek-moe-16b", False), ("kimi-k2-1t-a32b", False),
    ("jamba-1.5-large-398b", False), ("xlstm-125m", False)])
def test_capture_rule_reads_the_block_pattern(arch, want):
    """Attention with a dense FFN in every pattern entry captures; MoE
    (routing by the data) and recurrent entries run eagerly."""
    cfg = get_config(arch)
    assert capturable(cfg) is want
    dense = dataclasses.replace(cfg, ffn_kind=FFNKind.DENSE, moe=None)
    assert capturable(dense) is all(k == BlockKind.ATTN
                                    for k in cfg.block_pattern)


def test_engine_state_keeps_its_storage_and_replayed_steps_serve_its_tokens():
    """Through admission, chunked prefill, prefix publishes and hits,
    host->device migration and preemption, the decode and staging states
    keep their storage, and an engine whose every model step is served by
    the stand-in's replays emits the tokens of one that runs them
    eagerly."""
    cfg = dataclasses.replace(
        get_config("internlm2-1.8b").reduced(layers=4, d_model=64, vocab=64),
        param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(6)
    shared = list(rng.integers(0, 64, 16))

    def requests():
        """Two device residents, two host residents (which migrate as
        slots free), an urgent prompt too long for the pool's room that
        demotes a device resident, then two turns on the shared prefix."""
        r = np.random.default_rng(7)
        first = [Request(prompt=shared + list(r.integers(0, 64, 6)),
                         max_new_tokens=n) for n in (20, 20, 24, 24)]
        urgent = Request(prompt=list(r.integers(0, 64, 100)),
                         max_new_tokens=5, priority=1, deadline=120.0)
        later = [Request(prompt=shared + list(r.integers(0, 64, 6)),
                         max_new_tokens=4) for _ in range(2)]
        return first, {4: [urgent], 40: later}

    def run(replayed):
        eng = Engine(cfg, params, EngineConfig(
            device="cpu", device_slots=2, host_slots=4, cache_len=128,
            page_size=32, host_pool_pages=16, chunk_tokens=8,
            perf_model="analytic:a10", host_workers=2))
        if replayed:
            eng.graphs = StepGraphs(stand_in)
            eng._capture_steps()
        storage = [t.data_ptr() for st in (eng.state, eng.staging_state)
                   for e in st.per_entry for t in e]
        first, due = requests()
        served = list(first)
        try:
            for r in first:
                eng.submit(r)
            it = 0
            while (eng.has_work or due) and it < 2000:
                for r in due.pop(it, []):
                    eng.submit(r)
                    served.append(r)
                eng.step()
                it += 1
                assert [t.data_ptr() for st in (eng.state, eng.staging_state)
                        for e in st.per_entry for t in e] == storage
        finally:
            eng.shutdown()
        return [r.output for r in served], eng.stats

    outputs, stats = run(True)
    eager_outputs, eager_stats = run(False)
    assert outputs == eager_outputs
    # a swap, or a recompute where the calibrated prices say so
    assert stats.preemptions + stats.preemption_recomputes >= 1
    assert stats.migrations >= 1
    assert stats.prefix_hits >= 1 and stats.prefill_chunks >= 1
    assert stats.graph_steps == stats.model_steps > 0
    assert eager_stats.graph_steps == 0 < eager_stats.model_steps


def test_eager_steps_reuse_their_chain_until_the_state_moves():
    """An eager step builds its chain once for its shapes and binding and
    again when the state's storage changes, keeping one chain a step and
    shapes; the steps give the bits of steps run without a
    ``StepGraphs``."""
    cfg = get_config("internlm2-1.8b").reduced(d_model=64, vocab=96,
                                               layers=3)
    params = init_params(cfg, seed=4, device="cpu")
    dtype = params.embedding["embed"].dtype

    def states():
        return [init_decode_state(cfg, device_batch=2, host_batch=3,
                                  cache_len=16, device="cpu")
                for _ in range(2)]

    graphs = StepGraphs()
    state, plain = states()
    host = _zero_host(cfg, 3, dtype)._replace(
        x_carry=torch.randn((3, cfg.d_model)).to(dtype),
        positions=torch.tensor([4, 0, 2], dtype=torch.int32),
        attn_in=torch.randn((3, cfg.num_heads, cfg.resolved_head_dim)),
        consume_layer=1, emit_layer=2, window_start=0, window_end=2,
        row_valid=torch.tensor([True, False, True]))
    tokens = torch.tensor([5, 7])
    chains = []
    for step in range(4):
        if step == 2:                       # new storage: a new chain
            state, plain = states()
        got = decode_step(params, cfg, tokens, state, host, graphs=graphs)
        want = decode_step(params, cfg, tokens, plain, host)
        state, plain = got[1], want[1]
        assert _equal(got[0], want[0]) and _equal(got[3], want[3])
        assert all(_equal(a, b) for a, b in zip(got[2], want[2]))
        chains.append(next(iter(graphs._chains.values()))[1])
        assert len(graphs._chains) == 1
    assert chains[0] is chains[1] and chains[2] is chains[3]
    assert chains[1] is not chains[2]
    assert graphs.steps == 4 and graphs.replays == 0
