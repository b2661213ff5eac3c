"""The port's model against the JAX reference on the CPU.

Reference parameters are made with ``jax.random`` and carried across
with ``params_from_numpy``; both packages then prefill and decode the
same numpy-seeded tokens.  Logits are compared at rtol = atol = 1e-4:
looser than the 1e-5 kernel bar because the two frameworks sum matmuls
in other orders across 4 layers.  That comparison runs with an fp32 KV
cache on both sides; with the default bf16 cache an fp32 ULP difference
in a K or V value occasionally rounds to the neighbouring bf16 value
(6 of 4096 K elements for llama3.1-8b-reduced, seed 0), which moves
logits by ~2e-4 -- so the default-cache runs are held to greedy token
equality and a 2e-3 logit bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.models import (HostIO as RefHostIO, ModelParams as RefModelParams,
                          decode_step,
                          init_decode_state as ref_state,
                          init_params as ref_init, prefill as _ref_prefill,
                          prefill_bucketed as _ref_bucketed)
from repro_torch.configs import get_config, list_archs
from repro_torch.models import (HostIO, init_decode_state, params_from_numpy,
                                prefill, prefill_bucketed)
from repro_torch.models import decode_step as port_decode

# jitted once per (config, shapes) for the whole module
ref_decode = jax.jit(decode_step, static_argnums=(1,))
ref_prefill = jax.jit(_ref_prefill, static_argnums=(1,))
ref_bucketed = jax.jit(_ref_bucketed, static_argnums=(1,),
                       static_argnames=("cache_len", "kv_dtype"))

ARCHS = {
    "internlm2-1.8b": {},
    "llama3.1-8b": dict(layers=4, d_model=128, vocab=512),
}


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(arch, reference cfg, reference params, port cfg, port params), fp32."""
    arch = request.param
    kw = ARCHS[arch]
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(**kw),
                               param_dtype="float32",
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(**kw),
                              param_dtype="float32", compute_dtype="float32")
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    return arch, rcfg, rparams, cfg, params


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_configs_match_reference():
    assert "jamba-1.5-large-398b" in list_archs()
    for arch in list_archs():
        a = dataclasses.asdict(get_config(arch))
        b = dataclasses.asdict(ref_get_config(arch))
        assert {k: str(v) for k, v in a.items()} == \
            {k: str(v) for k, v in b.items()}, arch
        ra = dataclasses.asdict(get_config(arch).reduced(layers=4))
        rb = dataclasses.asdict(ref_get_config(arch).reduced(layers=4))
        assert {k: str(v) for k, v in ra.items()} == \
            {k: str(v) for k, v in rb.items()}, arch


def test_params_from_numpy_is_bit_exact_for_bf16():
    """bf16 leaves (ml_dtypes arrays, as np.asarray of the reference's
    jax arrays gives them) cross bit-exactly; the tree is the reference
    ModelParams layout, built from numpy to skip a jax init."""
    cfg = get_config("internlm2-1.8b").reduced(layers=2, d_model=64)
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    g, d, f, v = cfg.num_groups, cfg.d_model, cfg.d_ff, cfg.vocab_size
    block = {"ln1": {"scale": leaf(g, d)},
             "attn": {"wq": leaf(g, d, d), "wk": leaf(g, d, d),
                      "wv": leaf(g, d, d), "wo": leaf(g, d, d)},
             "ln2": {"scale": leaf(g, d)},
             "ffn": {"w_gate": leaf(g, d, f), "w_up": leaf(g, d, f),
                     "w_down": leaf(g, f, d)}}
    tree = RefModelParams(embedding={"embed": leaf(v, d),
                                     "unembed": leaf(d, v)},
                          blocks=(block,), final_norm={"scale": leaf(d)})
    params = params_from_numpy(cfg, tree, "cpu")
    pairs = [(params.embedding["unembed"], tree.embedding["unembed"]),
             (params.blocks[0]["attn"]["wq"], block["attn"]["wq"]),
             (params.blocks[0]["ffn"]["w_down"], block["ffn"]["w_down"])]
    for ours, src in pairs:
        assert ours.dtype == torch.bfloat16 and ours.shape == src.shape
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                      src.view(np.int16))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_prefill_decode_logits_and_greedy_tokens(pair, kv_dtype):
    arch, rcfg, rparams, cfg, params = pair
    jkv, tkv = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    tol = 1e-4 if kv_dtype == "float32" else 2e-3
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9))
    rst = ref_state(rcfg, device_batch=2, cache_len=32, kv_dtype=jkv)
    rlog, rst = ref_prefill(rparams, rcfg,
                            {"tokens": jnp.asarray(prompt, jnp.int32)}, rst)
    st = init_decode_state(cfg, device_batch=2, cache_len=32, device="cpu",
                           kv_dtype=tkv)
    log, st = prefill(params, cfg, {"tokens": torch.from_numpy(prompt)}, st)
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=tol, atol=tol)
    rtok = tok = None
    for _ in range(6):
        rtok = np.argmax(np.asarray(rlog), -1)
        tok = log.argmax(-1).numpy()
        np.testing.assert_array_equal(tok, rtok)
        rlog, rst, _, _ = ref_decode(rparams, rcfg,
                                     jnp.asarray(rtok, jnp.int32), rst)
        log, st, _, _ = port_decode(params, cfg, torch.from_numpy(tok), st)
        np.testing.assert_allclose(_np(log), _np(rlog), rtol=tol, atol=tol)
    assert int(st.lengths[0]) == 9 + 6


def test_bucketed_prefill_matches_per_request(pair):
    arch, rcfg, rparams, cfg, params = pair
    rng = np.random.default_rng(3)
    plens = [5, 8, 3]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    tokens = np.zeros((4, 8), np.int64)
    lens = np.ones((4,), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        lens[i] = len(p)
    logits, state = prefill_bucketed(params, cfg, torch.from_numpy(tokens),
                                     torch.from_numpy(lens), cache_len=32,
                                     kv_dtype=torch.float32)
    rlogits, _ = ref_bucketed(rparams, rcfg, jnp.asarray(tokens, jnp.int32),
                              jnp.asarray(lens, jnp.int32), cache_len=32,
                              kv_dtype=jnp.float32)
    np.testing.assert_allclose(_np(logits), _np(rlogits), rtol=1e-4,
                               atol=1e-4)
    for i, p in enumerate(prompts):
        st = init_decode_state(cfg, device_batch=1, cache_len=32,
                               device="cpu", kv_dtype=torch.float32)
        one, st = prefill(params, cfg, {"tokens": torch.from_numpy(p)[None]},
                          st)
        np.testing.assert_allclose(_np(logits[i]), _np(one[0]), rtol=1e-5,
                                   atol=1e-5)
        n = len(p)
        np.testing.assert_allclose(_np(state.per_entry[0].k[:, i, :n]),
                                   _np(st.per_entry[0].k[:, 0, :n]),
                                   rtol=1e-5, atol=1e-5)


# (consume_layer, emit_layer, window_start, window_end) over 4 layers
WINDOWS = [(-1, 0, 0, 0), (0, 1, 0, 1), (2, 3, 2, 3), (3, -1, 3, 4)]


@pytest.mark.parametrize("window", WINDOWS)
def test_host_rows_match_reference_decode_step(pair, window):
    """Device rows plus host ride-along rows with a commit window: the
    residuals, logits and emitted Q/K/V match the reference decode_step
    fed the same HostIO."""
    arch, rcfg, rparams, cfg, params = pair
    consume, emit, ws, we = window
    rng = np.random.default_rng(11)
    bg, bc, d = 2, 3, cfg.d_model
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    prompt = rng.integers(0, cfg.vocab_size, (bg, 6))
    x_carry = (rng.standard_normal((bc, d)) * 0.5).astype(np.float32)
    attn_in = rng.standard_normal((bc, h, hd)).astype(np.float32)
    positions = np.array([7, 3, 9], np.int32)
    row_valid = np.array([True, False, True])
    tokens = rng.integers(0, cfg.vocab_size, bg)

    rst = ref_state(rcfg, device_batch=bg, cache_len=32,
                    kv_dtype=jnp.float32)
    _, rst = ref_prefill(rparams, rcfg,
                         {"tokens": jnp.asarray(prompt, jnp.int32)}, rst)
    rhost = RefHostIO(
        x_carry=jnp.asarray(x_carry), positions=jnp.asarray(positions),
        attn_in=jnp.asarray(attn_in), consume_layer=jnp.int32(consume),
        emit_layer=jnp.int32(emit), window_start=jnp.int32(ws),
        window_end=jnp.int32(we), row_valid=jnp.asarray(row_valid))
    rlog, _, rqkv, rx = ref_decode(rparams, rcfg,
                                   jnp.asarray(tokens, jnp.int32), rst, rhost)

    st = init_decode_state(cfg, device_batch=bg, cache_len=32, device="cpu",
                           kv_dtype=torch.float32)
    _, st = prefill(params, cfg, {"tokens": torch.from_numpy(prompt)}, st)
    host = HostIO(
        x_carry=torch.from_numpy(x_carry),
        positions=torch.from_numpy(positions),
        attn_in=torch.from_numpy(attn_in), consume_layer=consume,
        emit_layer=emit, window_start=ws, window_end=we,
        row_valid=torch.from_numpy(row_valid))
    log, st, qkv, x = port_decode(params, cfg, torch.from_numpy(tokens), st,
                                  host)
    np.testing.assert_allclose(_np(x), _np(rx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=1e-4, atol=1e-4)
    for a, b in zip(qkv, rqkv):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)
    if not ws < we:     # outside the window host rows ride along untouched
        np.testing.assert_array_equal(_np(x[bg:]), x_carry)
