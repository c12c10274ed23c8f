"""The port's training pieces (`models/layers.py:cross_entropy_loss`,
`Model.loss`, remat in `models/transformer.py`, `train/optim.py`,
`train/compress.py`, `train/step.py`) against the JAX package's, on the
CPU.

Inputs come from numpy seeds and the parameters are the JAX package's
`init_model_params`, carried into the port by `params_from_numpy`. The
reduced configs compute in float32, so the two packages differ only by
float32 rounding in another summation order. Tolerances:

- the loss and its terms: rtol 1e-5 (the MoE aux loss 1e-4: it is ~1e-2
  and sums router probabilities in another order); the gradient norm
  rtol 1e-5; the gradient tree as one relative L2 error, 1e-4;
- `adamw_update` on identical gradients: the update (new - old
  parameters) as one relative L2 error over the tree, 1e-5; m, v and the
  qint8 scales within 1e-6 x the leaf's largest value; qint8 codes at
  most one apart (``round(x / scale)`` at .5) on at most 0.1% of entries;
- one train step: the update's relative L2 error, 1e-3. Adam's first
  step is lr * g / (|g| + eps), about lr * sign(g), so wherever a
  gradient entry is near zero a rounding difference flips the sign of
  its update; the ten configs read 3e-5 to 2.2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JShardedLoader
from repro.models import build_model as j_build_model
from repro.models import init_model_params as j_init_model_params
from repro.models import layers as j_layers
from repro.sharding import ctx as jctx
from repro.train import compress as j_compress
from repro.train import optim as j_optim
from repro_torch.configs import ASSIGNED, get_config, reduced
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.train import compress, optim
from repro_torch.train.step import (abstract_state, init_state,
                                    make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _no_installed_activation_specs():
    """The reference's train-step factory installs activation sharding
    specs for the whole process (`repro.sharding.ctx.install`), so a test
    of another file that built one leaves them set in this worker, and
    the reference's models then constrain to a mesh no test here entered.
    Start from none, as a fresh process does."""
    jctx.install(None)


LOSS_TOL = dict(atol=0.0, rtol=1e-5)
AUX_TOL = dict(atol=1e-9, rtol=1e-4)
GRAD_TOL = 1e-4
OPT_UPDATE_TOL = 1e-5
STATE_TOL = 1e-6
CODE_FLIPS = 1e-3
STEP_UPDATE_TOL = 1e-3
B, S = 2, 64
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=60)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    """One relative L2 error over lists of arrays."""
    g = np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in got])
    w = np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _tleaves(tree):
    return [t.detach().float().numpy().copy() for _, t in L.tree_items(tree)]


def _scaled_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= lim, (what, np.abs(got - want).max(),
                                             lim)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_loss(z_loss):
    rng = np.random.default_rng(21)
    logits = rng.normal(0, 3, (3, 17, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    labels[0, :5] = -1
    labels[2, 9] = -1
    want = j_layers.cross_entropy_loss(jnp.asarray(logits),
                                       jnp.asarray(labels), z_loss=z_loss)
    got = L.cross_entropy_loss(_t(logits), _t(labels), z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    # every label masked: zero, not a division by zero
    none = L.cross_entropy_loss(_t(logits), torch.full((3, 17), -1))
    assert float(none) == 0.0


# ---------------------------------------------------------------------------
# The optimiser
# ---------------------------------------------------------------------------

def test_schedule():
    cfg = optim.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    jcfg = j_optim.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = optim.schedule(torch.tensor(step, dtype=torch.int32), cfg)
        want = j_optim.schedule(jnp.asarray(step, jnp.int32), jcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _grad_tree(rng, scale):
    """Gradients of a parameter tree with a vector, matrices, a 3-D leaf
    and last axes that are not a multiple of the int8 block."""
    shapes = {"b": (300,), "w": (64, 200), "e": {"k": (3, 5, 130)},
              "g": (7,), "h": (16, 128)}
    return jax.tree.map(
        lambda s: (rng.normal(0, scale, s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_clip_by_global_norm(scale):
    rng = np.random.default_rng(22)
    g = _grad_tree(rng, scale)
    want, wn = j_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    got, gn = optim.clip_by_global_norm(L.tree_map(_t, g), 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(L.tree_map(_t, g))),
                               float(wn), rtol=1e-6)
    for a, b in zip(_tleaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)


@pytest.mark.parametrize("block", [128, 64, 1000])
def test_q8_encode_decode(block):
    rng = np.random.default_rng(23)
    x = np.abs(rng.normal(0, 1e-3, (6, 333))).astype(np.float32)
    x[2] = 0.0
    jq, js = j_optim._q8_encode(jnp.asarray(x), block)
    q, s = optim._q8_encode(_t(x), block)
    assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=STATE_TOL)
    diff = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert diff.max() <= 1 and diff.mean() <= CODE_FLIPS
    np.testing.assert_array_equal(
        optim._q8_decode(q, s, x.shape).numpy(),
        np.asarray(j_optim._q8_decode(jnp.asarray(q.numpy()),
                                      jnp.asarray(s.numpy()), x.shape)))


MOMENTS = {"f32-f32": (torch.float32, torch.float32, jnp.float32,
                       jnp.float32),
           "bf16-f32": (torch.bfloat16, torch.float32, jnp.bfloat16,
                        jnp.float32),
           "f32-qint8": (torch.float32, "qint8", jnp.float32, "qint8")}


def _v_leaves(v, params, qint8):
    """(values, codes, scales) of a port v tree, in the order of the
    parameters' leaves."""
    if not qint8:
        return _tleaves(v), None, None
    nodes = [optim._at(v, path) for path, _ in L.tree_items(params)]
    return None, [d["q"].numpy() for d in nodes], \
        [d["scale"].numpy() for d in nodes]


@pytest.mark.parametrize("moments", list(MOMENTS))
def test_adamw_update(moments):
    """Three updates on identical gradients (the third clipped), each
    side from its own state: the update, m, v (qint8: codes and scales)
    and the statistics."""
    rng = np.random.default_rng(24)
    m_t, v_t, m_j, v_j = MOMENTS[moments]
    cfg = optim.OptConfig(m_dtype=m_t, v_dtype=v_t, warmup_steps=2, **{
        k: v for k, v in OPT.items() if k != "warmup_steps"})
    jcfg = j_optim.OptConfig(m_dtype=m_j, v_dtype=v_j, warmup_steps=2, **{
        k: v for k, v in OPT.items() if k != "warmup_steps"})
    p0 = _grad_tree(rng, 0.05)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = L.tree_map(_t, p0)
    jst = j_optim.init_opt_state(jp, jcfg)
    tst = optim.init_opt_state(tp, cfg)
    jupdate = jax.jit(lambda g, s, p: j_optim.adamw_update(g, s, p, jcfg))
    qint8 = v_t == "qint8"
    for i, scale in enumerate((0.01, 0.02, 1.0)):
        g = _grad_tree(rng, scale)
        old = _tleaves(tp)
        jp_new, jst, jstats = jupdate(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst, stats = optim.adamw_update(L.tree_map(_t, g), tst, tp, cfg)
        assert int(tst["count"]) == int(jst["count"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert stats[k].dim() == 0
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=1e-6)
        got = [a - b for a, b in zip(_tleaves(tp), old)]
        want = [np.asarray(a) - b for a, b in zip(_leaves(jp_new), old)]
        assert _rel(got, want) <= OPT_UPDATE_TOL
        for a, b in zip(_tleaves(tst["m"]), _leaves(jst["m"])):
            _scaled_close(a, np.asarray(b, np.float32), STATE_TOL, "m")
        vals, codes, scales = _v_leaves(tst["v"], tp, qint8)
        if qint8:
            jitems = jax.tree_util.tree_leaves(
                jst["v"], is_leaf=lambda x: isinstance(x, dict) and "q" in x)
            for q, s, j in zip(codes, scales, jitems):
                np.testing.assert_allclose(s, np.asarray(j["scale"]),
                                           rtol=STATE_TOL)
                d = np.abs(q.astype(int) - np.asarray(j["q"]).astype(int))
                assert d.max() <= 1 and d.mean() <= CODE_FLIPS
        else:
            for a, b in zip(vals, _leaves(jst["v"])):
                _scaled_close(a, b, STATE_TOL, "v")
        jp = jp_new


def test_adamw_decays_matrices_only():
    """With a zero gradient the step is the decay alone: lr * wd * p on
    leaves of rank >= 2, nothing on vectors."""
    cfg = optim.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    p = {"w": torch.ones(4, 3), "b": torch.ones(3)}
    st = optim.init_opt_state(p, cfg)
    optim.adamw_update({"w": torch.zeros(4, 3), "b": torch.zeros(3)}, st, p,
                       cfg)
    lr = float(optim.schedule(torch.tensor(1), cfg))
    torch.testing.assert_close(p["w"], torch.full((4, 3), 1 - lr * 0.5))
    assert torch.equal(p["b"], torch.ones(3))


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 130), 64),
                                         ((3, 4, 5), 256)])
def test_quantize_block_int8(shape, block):
    rng = np.random.default_rng(25)
    x = rng.normal(0, 2, shape).astype(np.float32)
    jq, js = j_compress.quantize_block_int8(jnp.asarray(x), block)
    q, s = compress.quantize_block_int8(_t(x), block)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=STATE_TOL)
    d = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert d.max() <= 1 and d.mean() <= CODE_FLIPS
    np.testing.assert_array_equal(
        compress.dequantize_block_int8(_t(np.asarray(jq)), _t(np.asarray(js)),
                                       shape).numpy(),
        np.asarray(j_compress.dequantize_block_int8(jq, js, shape)))


def test_ef_compressor():
    """Two rounds of error feedback: the codes, the scales and the
    residual carried into the second round."""
    rng = np.random.default_rng(26)
    g1, g2 = (_grad_tree(rng, 1.0) for _ in range(2))
    jc, tc = j_compress.EFCompressor(block=64), compress.EFCompressor(block=64)
    jres = jc.init(jax.tree.map(jnp.asarray, g1))
    tres = tc.init(L.tree_map(_t, g1))
    assert all(float(t.abs().max()) == 0 for _, t in L.tree_items(tres))
    for g in (g1, g2):
        before = dict(L.tree_items(tres))
        jcomp, jres = jc.compress(jax.tree.map(jnp.asarray, g), jres)
        tcomp, tres = tc.compress(L.tree_map(_t, g), tres)
        jpairs = jax.tree_util.tree_leaves(
            jcomp, is_leaf=lambda x: isinstance(x, tuple))
        tpairs = [p for _, p in L.tree_items(tcomp)]
        for (q, s), (jq, js) in zip(tpairs, jpairs):
            np.testing.assert_allclose(s.numpy(), np.asarray(js),
                                       rtol=STATE_TOL)
            d = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
            assert d.max() <= 1 and d.mean() <= CODE_FLIPS
        for a, b in zip(_tleaves(tres), _leaves(jres)):
            _scaled_close(a, b, 1e-5, "residual")
    like = L.tree_map(_t, g2)
    back = tc.decompress(tcomp, like)
    for (_, a), (_, b), (_, r) in zip(L.tree_items(back), L.tree_items(like),
                                      L.tree_items(tres)):
        assert a.shape == b.shape and a.dtype == b.dtype
        # what was sent plus the new residual is what was to be sent: the
        # gradient plus the residual carried in
        torch.testing.assert_close(a + r, b + before[_], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# One train step, every config
# ---------------------------------------------------------------------------

def _batch(jcfg, seed: int = 0):
    """The loader's step-0 batch of B x S tokens and the inputs a family
    needs besides: whisper's frames, qwen2-vl's (B, S, 3) positions and
    patch embeddings."""
    b = JShardedLoader(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=seed)).batch(0)
    rng = np.random.default_rng(seed + 1)
    if jcfg.is_encdec:
        b["frames"] = rng.normal(size=(B, jcfg.enc_ctx, jcfg.d_model)) \
            .astype(np.float32)
    if jcfg.rope_style == "mrope":
        b["positions"] = rng.integers(0, S, (B, S, 3)).astype(np.int32)
    if jcfg.vlm_patches:
        b["patch_emb"] = rng.normal(0, 0.02, (B, jcfg.vlm_patches,
                                              jcfg.d_model)).astype(np.float32)
    return b


def _batch_tree(b):
    return {k: (v.shape, torch.int32 if v.dtype.kind == "i" else
                torch.float32) for k, v in b.items()}


@pytest.mark.parametrize("name", ASSIGNED)
def test_train_step_matches_the_reference(name):
    """The reference's ``value_and_grad(model.loss)`` then `adamw_update`
    (no mesh: see ROADMAP C.2) against the port's `make_train_step` on
    the same parameters and batch: loss, ce, aux, the gradient norm, the
    gradients, the update, and the metrics' names."""
    jcfg = j_reduced(j_get_config(name))
    jm = j_build_model(jcfg)
    tree = jax.tree.map(np.asarray, j_init_model_params(jm, 2))
    jp = jax.tree.map(jnp.asarray, tree)
    b = _batch(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    jcfg_opt = j_optim.OptConfig(**OPT)
    jnew, _, jstats = jax.jit(lambda g, s, p: j_optim.adamw_update(
        g, s, p, jcfg_opt))(jg, j_optim.init_opt_state(jp, jcfg_opt), jp)

    tm = build_model(reduced(get_config(name)), device="cpu")
    tp = params_from_numpy(tm, tree, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    loss, _ = tm.loss(tp, tb)
    leaves = [t.requires_grad_() for _, t in L.tree_items(tp)]
    grads = torch.autograd.grad(tm.loss(tp, tb)[0], leaves)
    assert _rel([g.numpy() for g in grads], _leaves(jg)) <= GRAD_TOL

    oc = optim.OptConfig(**OPT)
    bundle = make_train_step(tm, oc, _batch_tree(b), device="cpu")
    state = {"params": tp, "opt": optim.init_opt_state(tp, oc),
             "step": torch.zeros((), dtype=torch.int32)}
    old = _tleaves(tp)
    state, met = bundle.step_fn(state, b)
    assert sorted(met) == ["aux", "ce", "grad_norm", "loss", "lr", "step"]
    assert all(t.dim() == 0 and not t.requires_grad for t in met.values())
    assert int(met["step"]) == int(state["step"]) == 1
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **LOSS_TOL)
    np.testing.assert_allclose(float(met["loss"]), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               **AUX_TOL)
    assert (float(met["aux"]) > 0) == (jcfg.moe is not None)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["lr"]), float(jstats["lr"]),
                               rtol=1e-6)
    got = [a - b for a, b in zip(_tleaves(state["params"]), old)]
    want = [np.asarray(a) - b for a, b in zip(_leaves(jnew), old)]
    assert _rel(got, want) <= STEP_UPDATE_TOL


def test_tied_embedding_gradient_sums_both_uses():
    """qwen's tied embedding: its gradient is the lookup's part plus the
    head's; with the head's use detached only the lookup's is left."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    assert cfg.tie_embeddings
    tm = build_model(cfg, device="cpu")
    jm = j_build_model(j_reduced(j_get_config("qwen1.5-0.5b")))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray,
                                            j_init_model_params(jm, 1)),
                           device="cpu")
    b = {k: torch.as_tensor(v) for k, v in _batch(jm.cfg, 3).items()}
    emb = tp["embed"]["embedding"].requires_grad_()
    (full,) = torch.autograd.grad(tm.loss(tp, b)[0], [emb])
    right = L.unembed
    L.unembed = lambda p, x: right({"embedding": p["embedding"].detach()}, x)
    try:
        (lookup,) = torch.autograd.grad(tm.loss(tp, b)[0], [emb])
    finally:
        L.unembed = right
    used = torch.zeros(cfg.vocab_size, dtype=torch.bool)
    used[b["tokens"].reshape(-1)] = True
    assert torch.all(lookup[~used] == 0)
    assert float((full - lookup).norm()) > 0.1 * float(full.norm())


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "deepseek-moe-16b",
                                  "zamba2-7b"])
def test_remat_policies_give_equal_loss_and_gradients(name, monkeypatch):
    """none, dots and full: bitwise the same loss and gradients; with
    dots and full each repeat runs again in the backward pass (twice in
    all), with none once."""
    jm = j_build_model(j_reduced(j_get_config(name)))
    tree = jax.tree.map(np.asarray, j_init_model_params(jm, 4))
    b = {k: torch.as_tensor(v) for k, v in _batch(jm.cfg, 5).items()}
    calls = []
    right = tfm._repeat

    def counted(*a, **k):
        calls.append(1)
        return right(*a, **k)

    monkeypatch.setattr(tfm, "_repeat", counted)
    out = {}
    for remat in ("none", "dots", "full"):
        tm = build_model(dataclasses.replace(reduced(get_config(name)),
                                             remat=remat), device="cpu")
        tp = params_from_numpy(tm, tree, device="cpu")
        leaves = [t.requires_grad_() for _, t in L.tree_items(tp)]
        calls.clear()
        loss, _ = tm.loss(tp, b)
        grads = torch.autograd.grad(loss, leaves)
        repeats = sum(s.repeats for s in tm.plan)
        assert len(calls) == repeats * (1 if remat == "none" else 2)
        out[remat] = (loss.detach(), grads)
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, c in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, c), remat
    with pytest.raises(ValueError, match="remat"):
        tfm._remat(dataclasses.replace(reduced(get_config(name)),
                                       remat="some"))


# ---------------------------------------------------------------------------
# The state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_dtype", [torch.float32, "qint8"])
def test_init_state_and_abstract_state(v_dtype):
    cfg = reduced(get_config("deepseek-moe-16b"))
    tm = build_model(cfg, device="cpu")
    oc = optim.OptConfig(m_dtype=torch.bfloat16, v_dtype=v_dtype)
    st = init_state(tm, oc, 0, device="cpu")
    ab = abstract_state(tm, oc)
    a_items = dict(L.tree_items(ab))
    s_items = dict(L.tree_items(st))
    assert a_items.keys() == s_items.keys()
    for k, t in s_items.items():
        assert a_items[k].device.type == "meta"
        assert (a_items[k].shape, a_items[k].dtype) == (t.shape, t.dtype), k
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert st["params"]["stack"]["seg1"]["l0_moe"]["moe"]["router"].dtype \
        == torch.float32
    assert all(t.dtype == torch.bfloat16 for _, t in
               L.tree_items(st["opt"]["m"]))


def test_step_checks_the_batch():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    tm = build_model(cfg, device="cpu")
    oc = optim.OptConfig()
    b = ShardedLoader(DataConfig(cfg.vocab_size, 16, 2)).batch(0)
    bundle = make_train_step(tm, oc, _batch_tree(b), device="cpu")
    st = init_state(tm, oc, 0, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bundle.step_fn(st, ShardedLoader(DataConfig(cfg.vocab_size, 8,
                                                    2)).batch(0))
    with pytest.raises(ValueError, match="frames"):
        bundle.step_fn(st, {**b, "frames": np.zeros((2, 16, 64),
                                                    np.float32)})
    assert int(st["step"]) == 0
