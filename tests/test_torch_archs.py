"""The whole reference registry on the port, against the JAX reference on
the CPU.

Every config of ``repro.configs`` is reduced as the reference's own
``tests/test_archs_smoke.py`` reduces it (two pattern periods, d_model
64, vocab 128, four heads); the reference's weights cross by
``params_from_numpy`` and both packages take the same numpy-seeded
inputs: token ids, HuBERT's frame embeddings, PaliGemma's patch
embeddings ahead of its text.  In fp32 the logits of ``forward_train``
and of prefill + one decode step match at 1e-4 (matmuls summed in other
orders over up to 16 layers), and greedy tokens are equal.  In bf16
every stack's logits match at 3e-2, the reference's bf16 prefill bar,
against the reference compiled to round to bf16 wherever its code casts
(``xla_allow_excess_precision`` off for that computation): by default
XLA's CPU backend keeps fused bf16 intermediates in fp32, which puts a
few of llama3.1-8b-reduced's logits 0.05 apart and a recurrence's
further (ROADMAP queue 3); with it off, llama3.1-8b-reduced's bf16
logits are bitwise the port's.  The kernels' head geometries, which only the published widths
reach, are checked by their wrappers' ``check_geometry`` here and run on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import decode_step as _ref_decode
from repro.models import forward_train as _ref_forward
from repro.models import init_decode_state as ref_state
from repro.models import init_params as ref_init
from repro.models import prefill as _ref_prefill
from repro_torch.configs import get_config, list_archs
from repro_torch.core.profiler import OfflineProfiler
from repro_torch.kernels.decode_attention import \
    check_geometry as decode_geometry
from repro_torch.kernels.decode_attention import plan_splits
from repro_torch.kernels.prefill_attention import \
    check_geometry as prefill_geometry
from repro_torch.models import (decode_step, forward_train,
                                init_decode_state, init_params,
                                params_from_numpy, prefill)
from repro_torch.serving import Engine, EngineConfig

ref_forward = jax.jit(_ref_forward, static_argnums=(1,))
ref_prefill = jax.jit(_ref_prefill, static_argnums=(1,))
ref_decode = jax.jit(_ref_decode, static_argnums=(1,))

ARCHS = list_archs()
CAUSAL = [a for a in ARCHS if get_config(a).causal]


def _configs(arch, dtype):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(ref_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


_PAIRS = {}


def _pair(arch, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params), reused
    across the module's tests."""
    if (arch, dtype) not in _PAIRS:
        rcfg, cfg = _configs(arch, dtype)
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                   "cpu")
        _PAIRS[arch, dtype] = rcfg, rparams, cfg, params
    return _PAIRS[arch, dtype]


def _inputs(cfg, b=2, t=12, seed=0):
    """Numpy inputs per the frontend, as the reference's smoke test makes
    them (frames for the encoder, patches ahead of the VLM's text)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"embeds": rng.standard_normal(
            (b, t, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t))}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax(inputs):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in inputs.items()}


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_registry_matches_reference():
    assert list_archs() == ref_list_archs()
    assert list_archs(assigned_only=True) == \
        ref_list_archs(assigned_only=True)
    assert len(list_archs(assigned_only=True)) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    """Published and reduced configs equal the reference's field for
    field, and the properties the new families read agree."""
    mine, theirs = get_config(arch), ref_get_config(arch)
    as_str = lambda c: {k: str(v) for k, v in dataclasses.asdict(c).items()}
    assert as_str(mine) == as_str(theirs)
    assert as_str(mine.reduced()) == as_str(theirs.reduced())
    for prop in ("is_encoder_only", "has_kv_cache", "is_recurrent_decode",
                 "has_recurrent", "num_attn_layers", "resolved_head_dim"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop


@pytest.mark.parametrize("arch", ARCHS)
def test_init_names_and_shapes_match_reference(arch):
    """The port's own random init builds every leaf the reference's has,
    in its name, shape and dtype (xLSTM's gates and conv, the VLM's tied
    embedding without an ``unembed``, FFN-less xLSTM entries)."""
    rcfg, rparams, cfg, _ = _pair(arch)
    ours = init_params(cfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path

    def leaves(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in flat(tree)[0]}

    theirs = {k: (s, d) for k, (s, d) in leaves(rparams._asdict()).items()}
    mine = {k: (s, d.replace("torch.", ""))
            for k, (s, d) in leaves(ours._asdict()).items()}
    assert mine == theirs


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference_fp32(arch):
    """Logits of every position (on the VLM, patches and text) and the MoE
    load-balance loss, stateless: causal, full (the encoder) and
    prefix-LM attention over the span itself."""
    rcfg, rparams, cfg, params = _pair(arch)
    inputs = _inputs(cfg)
    rlog, raux = ref_forward(rparams, rcfg, _jax(inputs))
    log, aux = forward_train(params, cfg, _torch(inputs))
    t = 12 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert log.shape == (2, t, cfg.vocab_size)
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(log).argmax(-1),
                                  _np(rlog).argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference_bf16(arch):
    rcfg, rparams, cfg, params = _pair(arch, "bfloat16")
    inputs = _jax(_inputs(cfg, seed=1))
    exact = ref_forward.lower(rparams, rcfg, inputs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    rlog, _ = exact(rparams, inputs)
    log, _ = forward_train(params, cfg, _torch(_inputs(cfg, seed=1)))
    assert log.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill (the VLM's patches as a bidirectional prefix ahead of its
    text) and one greedy decode step over an fp32 cache on both sides:
    logits at 1e-4, the same greedy tokens."""
    rcfg, rparams, cfg, params = _pair(arch)
    inputs = _inputs(cfg, seed=2)
    rst = ref_state(rcfg, device_batch=2, cache_len=64, kv_dtype=jnp.float32)
    rlog, rst = ref_prefill(rparams, rcfg, _jax(inputs), rst)
    st = init_decode_state(cfg, device_batch=2, cache_len=64, device="cpu",
                           kv_dtype=torch.float32)
    log, st = prefill(params, cfg, _torch(inputs), st)
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=1e-4, atol=1e-4)
    tok = _np(log).argmax(-1)
    np.testing.assert_array_equal(tok, _np(rlog).argmax(-1))
    prompt = 12 + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert st.lengths.tolist() == [prompt, prompt]
    rlog, _, _, _ = ref_decode(rparams, rcfg, jnp.asarray(tok, jnp.int32),
                               rst)
    log, st, _, _ = decode_step(params, cfg, torch.from_numpy(tok), st)
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(log).argmax(-1), _np(rlog).argmax(-1))


def test_vlm_decode_matches_teacher_forcing():
    """The reference's prefill/decode consistency on the VLM: the decode
    step after prefilling patches + text gives the logits that
    ``forward_train`` computes at that position with the token appended
    (the prefix bidirectional in both)."""
    _, _, cfg, params = _pair("paligemma-3b")
    inputs = _inputs(cfg, seed=3)
    st = init_decode_state(cfg, device_batch=2, cache_len=64, device="cpu",
                           kv_dtype=torch.float32)
    log, st = prefill(params, cfg, _torch(inputs), st)
    tok = log.argmax(-1)
    dec, _, _, _ = decode_step(params, cfg, tok, st)
    longer = dict(_torch(inputs))
    longer["tokens"] = torch.cat([longer["tokens"], tok[:, None]], dim=1)
    full, _ = forward_train(params, cfg, longer)
    np.testing.assert_allclose(_np(dec), _np(full[:, -1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(log), _np(full[:, -2]), rtol=1e-4,
                               atol=1e-4)


def test_tied_embeddings_carried_across():
    """PaliGemma ties its output projection to the embedding: no
    ``unembed`` leaf on either side, and the logits are x @ embed^T."""
    rcfg, rparams, cfg, params = _pair("paligemma-3b")
    assert cfg.tie_embeddings
    assert "unembed" not in rparams.embedding
    assert set(params.embedding) == {"embed"}
    assert "unembed" not in init_params(cfg, device="cpu").embedding
    np.testing.assert_array_equal(params.embedding["embed"].numpy(),
                                  np.asarray(rparams.embedding["embed"]))


def test_encoder_attends_both_ways():
    """HuBERT's encoder (causal=False): a change to the last frame moves
    the first frame's logits, unlike a causal stack's."""
    _, _, cfg, params = _pair("hubert-xlarge")
    inputs = _torch(_inputs(cfg, seed=4))
    base, _ = forward_train(params, cfg, inputs)
    moved = dict(inputs)
    moved["embeds"] = inputs["embeds"].clone()
    moved["embeds"][:, -1] += 1.0
    other, _ = forward_train(params, cfg, moved)
    assert not torch.allclose(base[:, 0], other[:, 0])


def test_encoder_prefill_over_a_cache_matches_reference():
    """The encoder's prefill into a KV cache (full attention over the
    positions written so far, which the port asks of the causal kernel as
    a prefix reaching the span's end), twice in a row on one state: the
    last frame's logits as the reference's."""
    rcfg, rparams, cfg, params = _pair("hubert-xlarge")
    rst = ref_state(rcfg, device_batch=2, cache_len=32, kv_dtype=jnp.float32)
    st = init_decode_state(cfg, device_batch=2, cache_len=32, device="cpu",
                           kv_dtype=torch.float32)
    for seed, t in ((5, 7), (6, 5)):
        inputs = _inputs(cfg, t=t, seed=seed)
        rlog, rst = ref_prefill(rparams, rcfg, _jax(inputs), rst)
        log, st = prefill(params, cfg, _torch(inputs), st)
        np.testing.assert_allclose(_np(log), _np(rlog), rtol=1e-4,
                                   atol=1e-4)
    assert st.lengths.tolist() == [12, 12]


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["internlm2-20b", "llama3-405b",
                                  "paligemma-3b", "hubert-xlarge",
                                  "stablelm-12b"])
def test_kernels_take_the_published_head_geometries(arch, kernel):
    """Both wrappers accept the registry's published geometries (groups 6
    and 16, head_dim 80 and 256) that no reduced config reaches; decode
    is never asked for the encoder's (it has no decode) and refuses its
    head_dim 80."""
    cfg = get_config(arch)
    geometry = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    check = decode_geometry if kernel == "decode" else prefill_geometry
    if kernel == "decode" and not cfg.causal:
        with pytest.raises(ValueError, match="head_dim 80"):
            check(*geometry)
    else:
        check(*geometry)


@pytest.mark.parametrize("geometry", [(12, 4, 128), (8, 8, 96),
                                      (32, 1, 128), (8, 3, 64)])
def test_kernels_refuse_what_they_are_not_built_for(geometry):
    """Group 3, head_dim 96, group 32 and a head count the kv heads do
    not divide raise in both wrappers: there is no fallback."""
    for check in (decode_geometry, prefill_geometry):
        with pytest.raises(ValueError):
            check(*geometry)


def test_decode_split_plan_follows_occupancy():
    """At two resident CTAs per SM (D 256 in bf16) one wave holds half the
    splits of four: PaliGemma's 4 rows over its one kv head at S 512."""
    assert plan_splits(4, 1, 512, 132, ctas_per_sm=4) == 16
    assert plan_splits(64, 1, 8192, 132, ctas_per_sm=4) == 8
    assert plan_splits(64, 1, 8192, 132, ctas_per_sm=2) == 4


def test_engine_refuses_the_encoder():
    """The reference's engine runs hubert-xlarge by embedding token ids
    and decoding through full attention (ROADMAP queue 3); the port's
    engine and serve CLI refuse an encoder and name its path."""
    _, _, cfg, params = _pair("hubert-xlarge")
    with pytest.raises(ValueError, match="model.forward_train"):
        Engine(cfg, params, EngineConfig(device="cpu"))


def test_serve_cli_refuses_the_encoder(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "hubert-xlarge",
                                     "--device", "cpu"])
    with pytest.raises(ValueError, match="model.forward_train"):
        serve.main()


def test_profiler_prices_xlstm_as_the_reference():
    """The reference's profiler builds one attention layer (no FFN) from
    an xLSTM config and prices it as one attention layer (``ModelCosts``
    counts at least one); the port does the same on the CPU, table for
    table, and on the card refuses a head geometry its kernels do not
    take (xlstm-125m's 192), naming --perf-model analytic."""
    from repro.core.profiler import OfflineProfiler as RefProfiler
    rcfg, cfg = (get("xlstm-125m").reduced(d_model=64, vocab=64)
                 for get in (ref_get_config, get_config))
    grid = dict(token_counts=(1, 8), kv_positions=(256,),
                transfer_sizes=(1 << 12,))
    ref = RefProfiler(rcfg).run(**grid)
    mine = OfflineProfiler(cfg, device="cpu").run(**grid)
    assert ref.num_attn_layers == mine.num_attn_layers == 1
    assert set(ref.tables) == set(mine.tables)
    for name, (xs, ts) in mine.tables.items():
        np.testing.assert_array_equal(xs, ref.tables[name][0])
        assert (np.asarray(ts) > 0).all(), name
    big = get_config("xlstm-125m")
    assert big.resolved_head_dim == 192
    # refused before any device is touched, so this runs without a card
    with pytest.raises(NotImplementedError, match="perf-model analytic"):
        OfflineProfiler(big, device="cuda")
