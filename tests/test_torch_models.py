"""The port's LM stack, every family (`repro_torch.configs`,
`models/layers.py`, `models/attention.py`, `models/moe.py`,
`models/rwkv.py`, `models/mamba.py`, `models/transformer.py`,
`models/api.py`), against the JAX package's, on the CPU.

Inputs are drawn from a numpy seed; the parameters are the JAX package's
`init_model_params`, carried into the port by `params_from_numpy`, with
every bias and norm leaf redrawn from the seed so that the bias and scale
paths do real work (the reference initialises them to 0 and 1). Both
sides compute in float32 (the reduced configs' compute dtype), so the
tolerance is float32's: the two packages' products and reductions sum in
different orders. Functions are held to atol = rtol = 2e-5 (values of
order 1, sums over <= 128 terms); model logits, after two layers, the
final norm and a 256-way head, to atol = rtol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import attention as j_att
from repro.models import build_model as j_build_model
from repro.models import init_cache as j_init_cache
from repro.models import init_model_params as j_init_model_params
from repro.models import layers as j_layers
from repro.sharding import ctx as jctx
from repro_torch.configs import ASSIGNED, get_config, list_configs, reduced
from repro_torch.models import (build_model, cast_params, init_cache,
                                init_cast_params, init_model_params,
                                params_from_numpy)
from repro_torch.models import attention as att
from repro_torch.models import layers as L


@pytest.fixture(autouse=True, scope="module")
def _no_installed_activation_specs():
    """The reference's train-step factory installs activation sharding
    specs for the whole process (`repro.sharding.ctx.install`), so a test
    of another file that built one leaves them set in this worker, and
    the reference's models then constrain to a mesh no test here entered.
    Start from none, as a fresh process does."""
    jctx.install(None)


FN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# (config, tp_pad): tp_pad 16 pads starcoder2's 4 query heads over 2 kv
# heads to 16 (kv-major), so the padded-head mask does real work
DENSE = [("qwen1.5-0.5b", 1), ("h2o-danube-3-4b", 1), ("starcoder2-7b", 1),
         ("starcoder2-7b", 16)]
B, S, N_DECODE = 2, 64, 3


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(tree, rng):
    """Redraw the zero-initialised (bias) and one-initialised (norm scale)
    leaves of a numpy parameter tree, so their paths do real work."""
    def leaf(a):
        a = np.asarray(a)
        if np.all(a == 0) or np.all(a == 1):
            return (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(
                np.float32)
        return a
    return jax.tree.map(leaf, tree)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_every_reference_config_is_registered_alike():
    assert list_configs() == sorted(ASSIGNED)
    for name in ASSIGNED:
        mine = dataclasses.asdict(get_config(name))
        ref = dataclasses.asdict(j_get_config(name))
        for key in ("param_dtype", "compute_dtype"):
            assert str(mine.pop(key)).split(".")[-1] == \
                np.dtype(ref.pop(key)).name
        assert mine == ref, name
        assert dataclasses.asdict(reduced(get_config(name)))["d_model"] == \
            dataclasses.asdict(j_reduced(j_get_config(name)))["d_model"]


@pytest.mark.parametrize("name", ASSIGNED)
def test_full_width_schema_matches_the_reference(name):
    """Every parameter leaf of every config at its published widths has
    the reference's path, shape, axes and init rule, and the stack plan
    is the reference's (schemas only: nothing is allocated)."""
    mine = dict(L.tree_items(build_model(get_config(name),
                                         device="cpu").schema))
    ref = j_build_model(j_get_config(name)).schema
    ref = {tuple(k.key for k in path): p for path, p in
           jax.tree_util.tree_flatten_with_path(
               ref, is_leaf=lambda x: isinstance(x, j_layers.P))[0]}
    assert mine.keys() == ref.keys()
    for k, p in mine.items():
        assert (p.shape, p.axes, p.std) == (ref[k].shape, ref[k].axes,
                                            ref[k].std), k
    assert L.param_count(build_model(get_config(name), device="cpu").schema) \
        == j_layers.param_count(j_build_model(j_get_config(name)).schema)
    assert [(s.pattern, s.repeats) for s in
            build_model(get_config(name), device="cpu").plan] == \
        [(s.pattern, s.repeats) for s in
         j_build_model(j_get_config(name)).plan]


def test_entries_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = reduced(get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        init_model_params(model)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(model, 2, 16)
    params = jax.tree.map(np.asarray,
                          j_init_model_params(j_build_model(
                              j_reduced(j_get_config("qwen1.5-0.5b")))))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(model, params)


def test_params_from_numpy_checks_the_tree():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    model = build_model(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, j_init_model_params(
        j_build_model(j_reduced(j_get_config("qwen1.5-0.5b")))))
    params = params_from_numpy(model, tree, device="cpu")
    for (path, t), (_, p) in zip(L.tree_items(params),
                                 L.tree_items(model.schema)):
        assert tuple(t.shape) == p.shape and t.dtype == torch.float32, path
    bad = dict(tree, embed={"embedding": tree["embed"]["embedding"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(model, bad, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(model, {k: v for k, v in tree.items()
                                  if k != "final_norm"}, device="cpu")


def test_init_model_params_follows_the_leaf_rules():
    cfg = reduced(get_config("starcoder2-7b"))
    model = build_model(cfg, device="cpu")
    a = init_model_params(model, 5, device="cpu")
    b = init_model_params(model, 5, device="cpu")
    c = init_model_params(model, 6, device="cpu")
    for (path, x), (_, y), (_, z), (_, p) in zip(
            L.tree_items(a), L.tree_items(b), L.tree_items(c),
            L.tree_items(model.schema)):
        assert torch.equal(x, y), path
        if p.std == "ones":
            assert torch.all(x == 1), path
        elif p.std == 0.0:
            assert torch.all(x == 0), path
        else:
            assert not torch.equal(x, z), path
            assert abs(float(x.std()) / p.std - 1) < 0.2, path


# ---------------------------------------------------------------------------
# Layers and attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind, rng):
    x = rng.normal(1.0, 2.0, (3, 7, 64)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.2, 64).astype(np.float32),
         "bias": rng.normal(0, 0.2, 64).astype(np.float32)}
    want = j_layers.apply_norm(p, jnp.asarray(x), kind=kind, eps=1e-5)
    got = L.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind=kind,
                       eps=1e-5)
    _close(got, want, FN_TOL)


@pytest.mark.parametrize("gated,act,bias", [(True, "silu", False),
                                            (False, "gelu", True)])
def test_apply_mlp(gated, act, bias, rng):
    """Gated silu (llama/qwen) and the plain tanh-approximated gelu with
    biases (starcoder2): torch's gelu is exact unless asked for tanh."""
    schema = j_layers.mlp_schema(64, 128, gated=gated, bias=bias)
    p = jax.tree.map(np.asarray, j_layers.init_params(
        jax.random.PRNGKey(1), schema))
    p = _randomize(p, rng)
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    want = j_layers.apply_mlp(p, jnp.asarray(x), act=act)
    got = L.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act=act)
    _close(got, want, FN_TOL)


def test_apply_rope_neox(rng):
    x = rng.normal(0, 1, (2, 33, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 33)).astype(np.int32)
    want = j_att.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                            style="neox")
    got = att.apply_rope(_t(x), _t(pos), theta=1e6, style="neox")
    _close(got, want, FN_TOL)
    assert att.apply_rope(_t(x), _t(pos), theta=1e6, style="none") \
        .equal(_t(x))


@pytest.mark.parametrize("dh,sections", [(64, (2, 1, 1)), (128, (2, 1, 1)),
                                         (30, (1, 1, 1)), (64, (16, 24, 24))])
def test_apply_rope_mrope(dh, sections, rng):
    """M-RoPE with distinct t/h/w position streams (B, S, 3): the
    frequencies split between the streams as the reference's
    `_mrope_segments`."""
    x = rng.normal(0, 1, (2, 17, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 17, 3)).astype(np.int32)
    np.testing.assert_array_equal(att._mrope_segments(dh, sections),
                                  j_att._mrope_segments(dh, sections))
    want = j_att.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                            style="mrope", sections=sections)
    got = att.apply_rope(_t(x), _t(pos), theta=1e6, style="mrope",
                         sections=sections)
    _close(got, want, FN_TOL)
    # equal streams are the neox rotation of that stream
    same = np.repeat(pos[..., :1], 3, axis=-1)
    torch.testing.assert_close(
        att.apply_rope(_t(x), _t(same), theta=1e6, style="mrope",
                       sections=sections),
        att.apply_rope(_t(x), _t(same[..., 0]), theta=1e6, style="neox"))


BLOCKWISE = [(c, w, ch) for c in (True, False) for w in (None, 24)
             for ch in ((16, 16), (32, 64), (64, 37)) if c or w is None]


@pytest.mark.parametrize("causal,window,chunks", BLOCKWISE)
def test_blockwise_attention(causal, window, chunks, rng):
    """The cases of tests/test_models.py::test_blockwise_attention_vs_
    reference (sliding windows are causal), against the reference's
    blockwise path and the port's O(S^2) oracle."""
    q = rng.normal(size=(2, 128, 8, 32)).astype(np.float32)
    k = rng.normal(size=(2, 128, 4, 32)).astype(np.float32)
    v = rng.normal(size=(2, 128, 4, 32)).astype(np.float32)
    want = j_att.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=chunks[0], kv_chunk=chunks[1])
    got = att.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, q_chunk=chunks[0],
                                  kv_chunk=chunks[1])
    _close(got, want, FN_TOL)
    oracle = att.reference_attention(_t(q), _t(k), _t(v), causal=causal,
                                     window=window)
    _close(got, oracle.numpy(), FN_TOL)


def test_blockwise_attention_uneven_kv(rng):
    q = rng.normal(size=(1, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 1500 % 97, 4, 16)).astype(np.float32)
    v = rng.normal(size=(1, 1500 % 97, 4, 16)).astype(np.float32)
    want = j_att.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False,
                                     q_chunk=32, kv_chunk=32)
    got = att.blockwise_attention(_t(q), _t(k), _t(v), causal=False,
                                  q_chunk=32, kv_chunk=32)
    _close(got, want, FN_TOL)


@pytest.mark.parametrize("window", [None, 9])
def test_decode_attention(window, rng):
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 40, 4, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 40, 4, 16)).astype(np.float32)
    cl = np.array([0, 17, 39], np.int32)
    want = j_att.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(cl),
                                  window=window)
    got = att.decode_attention(_t(q), _t(kc), _t(vc), _t(cl), window=window)
    _close(got, want, FN_TOL)


def test_decode_attention_ring(rng):
    q = rng.normal(size=(4, 1, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(4, 12, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(4, 12, 2, 16)).astype(np.float32)
    cl = np.array([3, 11, 12, 40], np.int32)       # cold, warm, wrapped
    want = j_att.decode_attention_ring(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(cl))
    got = att.decode_attention_ring(_t(q), _t(kc), _t(vc), _t(cl))
    _close(got, want, FN_TOL)


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode on three reduced dense configs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE,
                ids=[f"{n}-tp{t}" for n, t in DENSE])
def pair(request):
    """(name, JAX model, its params, port model, the same params, tokens):
    the params redrawn where the reference initialises constants."""
    name, tp_pad = request.param
    jcfg = dataclasses.replace(j_reduced(j_get_config(name)), tp_pad=tp_pad)
    jm = j_build_model(jcfg)
    rng = np.random.default_rng(11)
    tree = _randomize(jax.tree.map(np.asarray, j_init_model_params(jm, 2)),
                      rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(dataclasses.replace(reduced(get_config(name)),
                                         tp_pad=tp_pad), device="cpu")
    assert att.padded_heads(tm.cfg)[0] == (16 if tp_pad == 16 else 4)
    tp = params_from_numpy(tm, tree, device="cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (B, S + N_DECODE))
    return name, jm, jp, tm, tp, tokens


def test_model_forward(pair):
    name, jm, jp, tm, tp, tokens = pair
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens,
                                                            jnp.int32)})
    got, aux = tm.forward(tp, {"tokens": torch.as_tensor(tokens)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, LOGIT_TOL)


def test_model_prefill_then_decode(pair):
    """Prefill S tokens into a cache of S + 8 rows (a 48-slot ring for
    h2o-danube's window), then decode N_DECODE tokens teacher-forced with
    a per-row cache_len (row 1 rewinds three positions, as a slot of a
    continuous batch would): every step's logits and the caches against
    the reference's."""
    name, jm, jp, tm, tp, tokens = pair
    jc = j_init_cache(jm, B, S + 8)
    tc = init_cache(tm, B, S + 8, device="cpu")
    for (_, a), (_, b) in zip(L.tree_items(tc), L.tree_items(
            jax.tree.map(np.asarray, jc))):
        assert tuple(a.shape) == b.shape
    if name == "h2o-danube-3-4b":
        assert tc["seg0"]["l0_attn"]["k"].shape[2] == 48
    first = {"tokens": tokens[:, :S]}
    want, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(
        first["tokens"], jnp.int32)}, jc)
    snapshot = L.tree_map(torch.clone, tc)
    got, tc2 = tm.prefill(tp, {"tokens": torch.as_tensor(first["tokens"])},
                          tc)
    _close(got, want, LOGIT_TOL)
    for (_, a), (_, b) in zip(L.tree_items(tc), L.tree_items(snapshot)):
        assert torch.equal(a, b), "prefill wrote into the caller's cache"
    tc = tc2
    jdec = jax.jit(jm.decode)
    for t in range(N_DECODE):
        cl = np.array([S + t, S - 3 + t], np.int32)
        tok = tokens[:, S + t:S + t + 1]
        want, jc = jdec(jp, {"tokens": jnp.asarray(tok, jnp.int32),
                             "cache_len": jnp.asarray(cl)}, jc)
        got, tc = tm.decode(tp, {"tokens": torch.as_tensor(tok),
                                 "cache_len": torch.as_tensor(cl)}, tc)
        assert got.shape == (B, 1, tm.cfg.vocab_size)
        _close(got, want, LOGIT_TOL)
    for (_, a), (_, b) in zip(L.tree_items(tc), L.tree_items(
            jax.tree.map(np.asarray, jc))):
        _close(a, b, FN_TOL)


def test_model_decode_matches_forward(pair):
    """Within the port: prefill + teacher-forced decode equals forward
    over the extended sequence (the tolerance of tests/test_models.py's
    cache check)."""
    name, jm, jp, tm, tp, tokens = pair
    cache = init_cache(tm, B, S + 8, device="cpu")
    last, cache = tm.prefill(tp, {"tokens": torch.as_tensor(tokens[:, :S])},
                             cache)
    full, _ = tm.forward(tp, {"tokens": torch.as_tensor(tokens)})
    torch.testing.assert_close(last[:, 0], full[:, S - 1], **LOGIT_TOL)
    for t in range(N_DECODE):
        got, cache = tm.decode(tp, {
            "tokens": torch.as_tensor(tokens[:, S + t:S + t + 1]),
            "cache_len": S + t}, cache)
        torch.testing.assert_close(got[:, 0], full[:, S + t], **LOGIT_TOL)


# ---------------------------------------------------------------------------
# The encoder-decoder family: reduced whisper-medium
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,d,dtype", [
    (1, 64, "float32"), (37, 64, "float32"), (8192, 1024, "float32"),
    (1500, 1024, "bfloat16"), (16, 30, "float32")])
def test_sinusoidal_positions(seq_len, d, dtype):
    """Bitwise the reference's table (float64 numpy, cast once)."""
    want = np.asarray(j_layers.sinusoidal_positions(
        seq_len, d, getattr(jnp, dtype)).astype(jnp.float32))
    got = L.sinusoidal_positions(seq_len, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.fixture(scope="module")
def whisper():
    """(JAX model, params, port model, the same params, tokens, frames)
    for reduced whisper-medium (2 + 2 layers, enc_ctx 16), the params
    redrawn where the reference initialises constants."""
    jm = j_build_model(j_reduced(j_get_config("whisper-medium")))
    rng = np.random.default_rng(13)
    tree = _randomize(jax.tree.map(np.asarray, j_init_model_params(jm, 2)),
                      rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(reduced(get_config("whisper-medium")), device="cpu")
    tp = params_from_numpy(tm, tree, device="cpu")
    cfg = tm.cfg
    tokens = rng.integers(0, cfg.vocab_size, (B, 12 + N_DECODE))
    frames = rng.normal(0, 0.5, (B, cfg.enc_ctx, cfg.d_model)).astype(
        np.float32)
    return jm, jp, tm, tp, tokens, frames


def test_whisper_plan_and_cache_schema(whisper):
    jm, _, tm, _, _, _ = whisper
    assert [(s.pattern, s.repeats) for s in tm.plan] == \
        [(s.pattern, s.repeats) for s in jm.plan] == \
        [((("attn", "cross", "mlp"),), 2)]
    mine = dict(L.tree_items(tm.cache_schema(3, 40)))
    ref = {tuple(k.key for k in path): p for path, p in
           jax.tree_util.tree_flatten_with_path(
               jm.cache_schema(3, 40),
               is_leaf=lambda x: isinstance(x, j_layers.P))[0]}
    assert mine.keys() == ref.keys()
    for k, p in mine.items():
        assert (p.shape, p.axes) == (ref[k].shape, ref[k].axes), k
    assert mine[("seg0", "l0_cross", "ek")].shape == (2, 3, 16, 4, 16)


def test_cross_attention_block(whisper, rng):
    """`attention_block` with ``cross_kv``: unmasked attention of x's
    queries over encoder K/V of another length (enc_ctx 16, 5 chunks of
    the reduced config's 32 at 150 frames)."""
    jm, jp, tm, tp, _, _ = whisper
    p = jax.tree.map(np.asarray, jp["stack"]["seg0"]["l0_cross"]["attn"])
    p = {k: v[0] for k, v in p.items()}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    k = rng.normal(size=(2, 150, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 150, 4, 16)).astype(np.float32)
    want, _ = j_att.attention_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg=jm.cfg,
        positions=None, cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, none = att.attention_block(
        {n: _t(a) for n, a in p.items()}, _t(x), cfg=tm.cfg, positions=None,
        cross_kv=(_t(k), _t(v)))
    assert none is None
    _close(got, want, FN_TOL)


def test_whisper_forward(whisper):
    jm, jp, tm, tp, tokens, frames = whisper
    batch = {"tokens": tokens[:, :12], "frames": frames}
    want, _ = jax.jit(jm.forward)(jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got, aux = tm.forward(tp, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    assert float(aux) == 0.0
    _close(got, want, LOGIT_TOL)


def test_whisper_prefill_then_decode(whisper):
    """Prefill (the encoder, then the encoder K/V stored in the cache),
    then decode with a per-row cache_len that reads them back: every
    step's logits and the whole cache against the reference's."""
    jm, jp, tm, tp, tokens, frames = whisper
    jc = j_init_cache(jm, B, 32)
    tc = init_cache(tm, B, 32, device="cpu")
    first = {"tokens": tokens[:, :12], "frames": frames}
    want, jc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v)
                                        for k, v in first.items()}, jc)
    got, tc = tm.prefill(tp, {k: torch.as_tensor(v)
                              for k, v in first.items()}, tc)
    _close(got, want, LOGIT_TOL)
    assert tc["seg0"]["l0_cross"]["ek"][1].abs().sum() > 0
    jdec = jax.jit(jm.decode)
    for t in range(N_DECODE):
        cl = np.array([12 + t, 9 + t], np.int32)
        tok = tokens[:, 12 + t:13 + t]
        want, jc = jdec(jp, {"tokens": jnp.asarray(tok, jnp.int32),
                             "cache_len": jnp.asarray(cl)}, jc)
        got, tc = tm.decode(tp, {"tokens": torch.as_tensor(tok),
                                 "cache_len": torch.as_tensor(cl)}, tc)
        _close(got, want, LOGIT_TOL)
    for (_, a), (_, b) in zip(L.tree_items(tc), L.tree_items(
            jax.tree.map(np.asarray, jc))):
        _close(a, b, FN_TOL)


def test_whisper_decode_with_enc_out_override(whisper, rng):
    """Decode without a cache reads the encoder output from the batch's
    ``enc_out`` (the reference's override), positions at cache_len."""
    jm, jp, tm, tp, tokens, _ = whisper
    enc = rng.normal(size=(B, 10, 64)).astype(np.float32)
    batch = {"tokens": tokens[:, :1], "cache_len": np.array([0, 5]),
             "enc_out": enc}
    want, _ = jax.jit(jm.decode)(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, None)
    got, cache = tm.decode(tp, {k: torch.as_tensor(v)
                                for k, v in batch.items()}, None)
    assert cache is None
    _close(got, want, LOGIT_TOL)


def test_whisper_prefill_refuses_another_frame_count(whisper):
    _, _, tm, tp, tokens, frames = whisper
    cache = init_cache(tm, B, 32, device="cpu")
    with pytest.raises(ValueError, match="enc_ctx"):
        tm.prefill(tp, {"tokens": torch.as_tensor(tokens[:, :4]),
                        "frames": torch.as_tensor(frames[:, :9])}, cache)


# ---------------------------------------------------------------------------
# The other families: MoE, RWKV-6, the Mamba2 hybrid, M-RoPE
# ---------------------------------------------------------------------------

FAMILIES = ["deepseek-moe-16b", "llama4-maverick-400b-a17b", "rwkv6-7b",
            "zamba2-7b", "qwen2-vl-2b"]


def _family_batch(cfg, tokens, rng):
    """The batch of ``tokens`` (B, S): for qwen2-vl also patch embeddings
    over the first vlm_patches positions and (B, S, 3) positions whose
    t/h/w streams differ (an image's rows and columns, then text)."""
    batch = {"tokens": tokens}
    if cfg.vlm_patches:
        Bn, Sn = tokens.shape
        n = cfg.vlm_patches
        t = np.arange(Sn)
        h = np.where(t < n, t // 2, t)
        w = np.where(t < n, t % 2 + 3, t)
        batch["positions"] = np.broadcast_to(
            np.stack([t, h, w], -1)[None], (Bn, Sn, 3)).astype(np.int32)
        batch["patch_emb"] = rng.normal(0, 0.5, (Bn, n, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _slice(batch, lo, hi, cfg):
    out = {"tokens": batch["tokens"][:, lo:hi]}
    if "positions" in batch:
        out["positions"] = batch["positions"][:, lo:hi]
    if "patch_emb" in batch and lo == 0:
        out["patch_emb"] = batch["patch_emb"]
    return out


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, JAX model, its params, port model, the same params, batch)
    for a reduced config of each family, the params redrawn where the
    reference initialises constants."""
    name = request.param
    jm = j_build_model(j_reduced(j_get_config(name)))
    rng = np.random.default_rng(17)
    tree = _randomize(jax.tree.map(np.asarray, j_init_model_params(jm, 2)),
                      rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(reduced(get_config(name)), device="cpu")
    tp = params_from_numpy(tm, tree, device="cpu")
    tokens = rng.integers(0, tm.cfg.vocab_size, (B, S + N_DECODE))
    return name, jm, jp, tm, tp, _family_batch(tm.cfg, tokens, rng)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tt(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def test_family_plan_schema_and_param_count(family):
    name, jm, _, tm, _, _ = family
    assert [(s.pattern, s.repeats) for s in tm.plan] == \
        [(s.pattern, s.repeats) for s in jm.plan]
    assert L.param_count(tm.schema) == j_layers.param_count(jm.schema)
    mine = dict(L.tree_items(tm.cache_schema(3, 40)))
    ref = {tuple(k.key for k in path): p for path, p in
           jax.tree_util.tree_flatten_with_path(
               jm.cache_schema(3, 40),
               is_leaf=lambda x: isinstance(x, j_layers.P))[0]}
    assert mine.keys() == ref.keys()
    for k, p in mine.items():
        assert (p.shape, p.axes) == (ref[k].shape, ref[k].axes), k
        assert str(p.dtype or torch.float32).split(".")[-1] == \
            np.dtype(ref[k].dtype or jnp.float32).name, k


def test_family_forward(family):
    """Logits and the MoE aux loss against the reference's forward."""
    name, jm, jp, tm, tp, batch = family
    first = _slice(batch, 0, S, tm.cfg)
    want, jaux = jax.jit(jm.forward)(jp, _j(first))
    got, aux = tm.forward(tp, _tt(first))
    _close(got, want, LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=0)
    assert (float(aux) > 0) == (tm.cfg.moe is not None)


def test_family_prefill_then_decode(family):
    """Prefill S tokens, then N_DECODE teacher-forced decode steps with a
    per-row cache_len: every step's logits and the whole cache (K/V and
    recurrent state) against the reference's."""
    name, jm, jp, tm, tp, batch = family
    jc = j_init_cache(jm, B, S + 8)
    tc = init_cache(tm, B, S + 8, device="cpu")
    first = _slice(batch, 0, S, tm.cfg)
    want, jc = jax.jit(jm.prefill)(jp, _j(first), jc)
    snapshot = L.tree_map(torch.clone, tc)
    got, tc2 = tm.prefill(tp, _tt(first), tc)
    _close(got, want, LOGIT_TOL)
    for (_, a), (_, b) in zip(L.tree_items(tc), L.tree_items(snapshot)):
        assert torch.equal(a, b), "prefill wrote into the caller's cache"
    tc = tc2
    jdec = jax.jit(jm.decode)
    for t in range(N_DECODE):
        step = _slice(batch, S + t, S + t + 1, tm.cfg)
        step["cache_len"] = np.array([S + t, S + t], np.int32)
        want, jc = jdec(jp, _j(step), jc)
        got, tc = tm.decode(tp, _tt(step), tc)
        assert got.shape == (B, 1, tm.cfg.vocab_size)
        _close(got, want, LOGIT_TOL)
    for (path, a), (_, b) in zip(L.tree_items(tc), L.tree_items(
            jax.tree.map(np.asarray, jc))):
        _close(a, b, LOGIT_TOL)


def test_family_decode_matches_forward(family):
    """Within the port: prefill + teacher-forced decode equals forward over
    the extended sequence (MoE at a capacity that drops nothing, so that
    the grouping of tokens cannot change who is dropped)."""
    name, jm, jp, tm, tp, batch = family
    if tm.cfg.moe is not None:
        tm = build_model(dataclasses.replace(tm.cfg, moe=dataclasses.replace(
            tm.cfg.moe, capacity_factor=8.0)), device="cpu")
    cache = init_cache(tm, B, S + 8, device="cpu")
    last, cache = tm.prefill(tp, _tt(_slice(batch, 0, S, tm.cfg)), cache)
    full, _ = tm.forward(tp, _tt(_slice(batch, 0, S + N_DECODE, tm.cfg)))
    torch.testing.assert_close(last[:, 0], full[:, S - 1], **LOGIT_TOL)
    for t in range(N_DECODE):
        step = _slice(batch, S + t, S + t + 1, tm.cfg)
        step["cache_len"] = S + t
        got, cache = tm.decode(tp, _tt(step), cache)
        torch.testing.assert_close(got[:, 0], full[:, S + t], **LOGIT_TOL)


def test_family_loader_is_init_then_cast(family):
    """`init_cast_params` (one leaf at a time) is bitwise
    ``cast_params(init_model_params(...))`` in bfloat16 compute, and the
    leaves it leaves in float32 are the ones the reference reads in
    float32: norms, the embedding and head, the MoE router and RWKV's and
    Mamba2's decay, bonus and group-norm parameters."""
    name, _, _, tm, _, _ = family
    m = build_model(dataclasses.replace(tm.cfg, compute_dtype=torch.bfloat16),
                    device="cpu")
    want = cast_params(m, init_model_params(m, 5, device="cpu"))
    got = init_cast_params(m, 5, device="cpu")
    kept = set()
    for (path, a), (p2, b) in zip(L.tree_items(got), L.tree_items(want)):
        assert path == p2 and a.dtype == b.dtype and torch.equal(a, b), path
        if a.dtype == torch.float32:
            kept.add(path[-1] if path[-2] not in ("embed", "head")
                     else path[-2])
    float32 = {"scale", "bias", "embed", "head", "router", "w0", "wA", "wB",
               "u", "gn_scale", "gn_bias", "A_log", "D", "dt_bias"}
    assert kept <= float32, kept - float32
