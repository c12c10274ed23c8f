"""Parity of the port's plain numerics (`repro_torch.core`) with the JAX
reference (`repro.core`), on the CPU, at small sizes. Inputs are made with
numpy from a seed and handed to both packages.

Tolerances, and why:
* masks, gaps, the interval time features and the SVM class: exact
  (comparisons, integer gaps, f32 sums of small integers, IEEE division
  and sqrt);
* FIR output: atol 1e-6 — the same taps in the same order, but XLA may
  contract the multiply-add into an FMA (|x| < 3, so 1e-6 is a few ulp);
* rFFT planes and band powers: rtol/atol 1e-5 (rFFT atol 1e-4 on values
  up to ~100) — the butterflies run in the same order, the segment mean
  and the band sums are reductions in another order;
* SVM margin: atol 1e-4 — margins reach a few hundred, and the product
  sums twelve terms in another order than XLA's dot.
"""
import numpy as np
import pytest
import torch

from repro.core import biosignal as jbio
from repro.core import fft as jfft
from repro.core import fir as jfir
from repro_torch.core import biosignal as tbio
from repro_torch.core import fft as tfft
from repro_torch.core import fir as tfir

import jax
import jax.numpy as jnp

# the reference functions, jitted once per shape (eager JAX dispatches the
# sorting networks op by op, which is slower than one compile)
_j_masked = jax.jit(lambda m: jbio._masked_intervals(m, sparse2=True))
_j_masked_sort = jax.jit(jbio._masked_intervals_sort)
_j_features = jax.jit(jbio.extract_features, static_argnums=1)
_j_fft = jax.jit(jfft.fft)
_j_rfft = jax.jit(jfft.rfft_packed)
_j_delineate = jax.jit(jbio.delineate)


def _np(x):
    return np.asarray(x)


def _filtered(rows=6, samples=512, seed=0):
    """Low-pass filtered synthetic respiration, as numpy float32."""
    sig = _np(jbio.synthetic_respiration(rows, samples, seed=seed)[0])
    return np.asarray(tfir.fir_direct(torch.as_tensor(sig),
                                      tfir.lowpass_taps()))


@pytest.mark.parametrize("n_taps", [3, 11])
def test_fir_direct_and_taps(n_taps):
    taps = tfir.lowpass_taps(n_taps)
    np.testing.assert_array_equal(taps, jfir.lowpass_taps(n_taps))
    x = np.random.default_rng(n_taps).standard_normal((3, 300)).astype(
        np.float32)
    got = tfir.fir_direct(torch.as_tensor(x), taps).numpy()
    want = _np(jfir.fir_direct(jnp.asarray(x), jnp.asarray(taps)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jfir.fir_reference(x, taps), atol=1e-5)


@pytest.mark.parametrize("n", [8, 256])
def test_complex_fft(n):
    rng = np.random.default_rng(n)
    re, im = rng.standard_normal((2, 4, n)).astype(np.float32)
    got = tfft.fft(torch.as_tensor(re), torch.as_tensor(im))
    want = _j_fft(jnp.asarray(re), jnp.asarray(im))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5)
    inv = tfft.fft(*got, inverse=True)
    np.testing.assert_allclose(inv[0].numpy(), re, atol=1e-5)


def test_rfft_packed():
    x = _filtered(4, 512)
    got = tfft.rfft_packed(torch.as_tensor(x))
    want = _j_rfft(jnp.asarray(x))
    ref = np.fft.rfft(x.astype(np.float64))
    for g, w, r in zip(got, want, (ref.real, ref.imag)):
        assert g.shape == (4, 257)
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("d", [1, 5, 15])
def test_dilate_is_exact(d):
    x = _filtered(3, 256, seed=d)
    for tr, jr in ((torch.maximum, jnp.maximum), (torch.minimum, jnp.minimum)):
        got = tbio._dilate(torch.as_tensor(x), tr, d).numpy()
        np.testing.assert_array_equal(got, _np(jbio._dilate(jnp.asarray(x),
                                                            jr, d)))
        # the clamped-window form the kernel computes
        S = x.shape[-1]
        red = np.max if tr is torch.maximum else np.min
        clamp = np.stack([red(x[:, max(0, t - d): t + d + 1], axis=-1)
                          for t in range(S)], axis=-1)
        np.testing.assert_array_equal(got, clamp)


@pytest.mark.parametrize("seed", [0, 1])
def test_delineate_masks_and_gaps(seed):
    x = _filtered(6, 512, seed=seed)
    t_max, t_min = tbio.delineate(torch.as_tensor(x))
    j_max, j_min = _j_delineate(jnp.asarray(x))
    np.testing.assert_array_equal(t_max.numpy(), _np(j_max))
    np.testing.assert_array_equal(t_min.numpy(), _np(j_min))
    assert t_max.any() and t_min.any()
    for tm, jm in ((t_max, j_max), (t_min, j_min)):
        g, v = tbio._interval_gaps(tm)
        jg, jv = jbio._interval_gaps(jm)
        np.testing.assert_array_equal(g.numpy(), _np(jg))
        np.testing.assert_array_equal(v.numpy(), _np(jv))


def _mask_cases():
    rng = np.random.default_rng(7)
    S = 512
    sparse = np.zeros((4, S), bool)
    for r in range(4):
        sparse[r, rng.choice(np.arange(1, S - 1, 20), 12, replace=False)] = 1
    one_collides = sparse.copy()
    one_collides[2, 100:102] = True          # one adjacent pair in row 2
    dense = rng.random((4, S)) < 0.5         # folds collide: full fallback
    empty = np.zeros((4, S), bool)
    empty[1, 40] = True                      # a single extremum: no gap
    empty[3, [5, 6, 300]] = True             # adjacent pair + one more
    return {"sparse": sparse, "one_row_collides": one_collides,
            "dense": dense, "empty_and_single": empty}


@pytest.mark.parametrize("case", sorted(_mask_cases()))
def test_masked_intervals_exact(case):
    """Mean, median and RMS equal the reference's on every branch of its
    sorting networks (fast fold, batch-wide collide fallback)."""
    mask = _mask_cases()[case]
    got = tbio._masked_intervals(torch.as_tensor(mask))
    want = _j_masked(jnp.asarray(mask))
    oracle = _j_masked_sort(jnp.asarray(mask))
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), _np(w))
        np.testing.assert_array_equal(g.numpy(), _np(o))


def test_extract_features_and_svm():
    x = _filtered(4, 512, seed=3)
    got = tbio.extract_features(torch.as_tensor(x), 512)
    want = _np(_j_features(jnp.asarray(x), 512))
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got[:, :6].numpy(), want[:, :6])
    np.testing.assert_allclose(got[:, 6:].numpy(), want[:, 6:], rtol=1e-5,
                               atol=1e-5)
    japp = jbio.make_app(seed=2)
    margin, cls = tbio.svm_predict(got, torch.as_tensor(_np(japp.svm_w)),
                                   torch.as_tensor(_np(japp.svm_b)))
    jm, jc = jbio.svm_predict(jnp.asarray(want), japp.svm_w, japp.svm_b)
    np.testing.assert_allclose(margin.numpy(), _np(jm), rtol=1e-5, atol=1e-4)
    assert cls.dtype == torch.int32
    np.testing.assert_array_equal(cls.numpy(), _np(jc))


def test_svm_class_takes_first_index_on_ties():
    feats = torch.ones((3, 12))
    w = torch.zeros((12, 3))
    b = torch.tensor([1.0, 2.0, 2.0])
    _, cls = tbio.svm_predict(feats, w, b)
    assert cls.tolist() == [1, 1, 1]


@pytest.mark.parametrize("seed", [0, 5])
def test_make_app_draws_the_reference_weights(seed):
    app = tbio.make_app(seed=seed, device="cpu")
    japp = jbio.make_app(seed=seed)
    np.testing.assert_array_equal(app.svm_w.numpy(), _np(japp.svm_w))
    np.testing.assert_array_equal(app.svm_b.numpy(), _np(japp.svm_b))
    np.testing.assert_array_equal(app.fir_taps.numpy(), japp.fir_taps)
    assert app.fft_size == japp.fft_size
    assert sorted(dict(app.named_buffers())) == ["fir_taps", "svm_b",
                                                 "svm_w"]


def test_synthetic_respiration_is_the_reference_draw():
    sig, lab = tbio.synthetic_respiration(3, 700, seed=4, device="cpu")
    jsig, jlab = jbio.synthetic_respiration(3, 700, seed=4)
    assert sig.dtype == torch.float32 and lab.dtype == torch.int32
    np.testing.assert_array_equal(sig.numpy(), _np(jsig))
    np.testing.assert_array_equal(lab.numpy(), _np(jlab))


def test_app_from_numpy_round_trip():
    """The JAX app's parameters carried over as numpy arrays give the same
    staged application."""
    japp = jbio.make_app(seed=1)
    app = tbio.app_from_numpy(japp.fir_taps, _np(japp.svm_w),
                              _np(japp.svm_b), japp.fft_size, device="cpu")
    np.testing.assert_array_equal(app.svm_w.numpy(), _np(japp.svm_w))
    np.testing.assert_array_equal(app.fir_taps.numpy(), japp.fir_taps)
    sig = _np(jbio.synthetic_respiration(4, 512, seed=9)[0])
    got = app(torch.as_tensor(sig))
    want = {k: _np(v) for k, v in jax.jit(japp.__call__)(
        jnp.asarray(sig)).items()}
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["filtered"].numpy(), want["filtered"],
                               atol=1e-6)
    np.testing.assert_array_equal(got["features"][:, :6].numpy(),
                                  want["features"][:, :6])
    np.testing.assert_allclose(got["features"].numpy(), want["features"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["margin"].numpy(), want["margin"],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["class"].numpy(), want["class"])


# ------------------------------------------- sorting network, bit-reversed
# FFT and the SVM fit (the rest of `core/`)

@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 128, 512])
def test_oddeven_tables_match_reference(n):
    for got, want in zip(tbio.oddeven_tables(n), jbio.oddeven_tables(n)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_network_sort_matches_np_sort(dtype):
    """`tests/test_biosignal.py::test_network_sort_matches_np_sort`'s
    cases: the port's network equals np.sort and the reference's network
    bitwise, with its own tables and with the reference's passed in."""
    rng = np.random.default_rng(0)
    j_sort = jax.jit(jbio.network_sort)
    for n in (1, 2, 4, 16, 128, 512):
        x = rng.integers(-1000, 1000, size=(5, n)).astype(dtype)
        if dtype == np.float32:
            x = x / np.float32(7)
        want = np.sort(x, axis=-1)
        got = tbio.network_sort(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _np(j_sort(jnp.asarray(x))))
        got2 = tbio.network_sort(torch.as_tensor(x),
                                 tables=jbio.oddeven_tables(n)).numpy()
        np.testing.assert_array_equal(got2, want)
    with pytest.raises(ValueError, match="power-of-two"):
        tbio.network_sort(torch.zeros(3, 6))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [8, 64, 256, 1024])
def test_fft_bitrev_matches_reference(n, inverse):
    """`tests/test_fft.py::test_core_fft_vs_numpy`'s bitrev cases in both
    packages: the same butterflies in the same order, so the two agree to
    atol 1e-5 x max |X| (XLA may contract a product and a sum into an
    FMA), and both within 1e-4 of numpy relative to the largest output."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))).astype(
        np.complex64)
    rr, ri = tfft.fft_bitrev(torch.as_tensor(x.real),
                             torch.as_tensor(x.imag), inverse=inverse)
    jr, ji = jfft.fft_bitrev(jnp.asarray(x.real), jnp.asarray(x.imag),
                             inverse=inverse)
    got = rr.numpy() + 1j * ri.numpy()
    scale = np.abs(got).max()
    np.testing.assert_allclose(got, _np(jr) + 1j * _np(ji), rtol=0,
                               atol=1e-5 * scale)
    ref = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    # the Stockham chain computes the same transform
    sr, si = tfft.fft(torch.as_tensor(x.real), torch.as_tensor(x.imag),
                      inverse=inverse)
    np.testing.assert_allclose(got, sr.numpy() + 1j * si.numpy(), rtol=0,
                               atol=1e-5 * scale)
    # the oracle is torch.fft's
    fr, fi = tfft.fft_reference(torch.as_tensor(x))
    np.testing.assert_allclose(fr.numpy() + 1j * fi.numpy(), np.fft.fft(x),
                               rtol=0, atol=1e-4 * np.abs(np.fft.fft(x)).max())


def test_fft_bitrev_real_input_defaults_im_to_zero():
    x = np.random.default_rng(2).normal(size=(2, 32)).astype(np.float32)
    rr, ri = tfft.fft_bitrev(torch.as_tensor(x))
    np.testing.assert_allclose(rr.numpy() + 1j * ri.numpy(), np.fft.fft(x),
                               rtol=0, atol=1e-4 * np.abs(np.fft.fft(x)).max())


# The app's fit is a 12x12 float32 solve of a normal matrix whose
# condition number is ~8e8 (interval features in the hundreds beside log
# band powers near 1), through LAPACK in two libraries. Each package lands
# 1.7e-3 (port) and 3.7e-3 (reference) x max |w| from a float64 solve of
# the same system, and their b within 7.4e-4 x max |b| of it; so each is
# held to 5e-3 of max |w| and |b| from the float64 fit, the two to 1e-2
# of each other, and the holdout classes exactly.
SVM_FIT_RTOL = 1e-2
SVM_FIT_F64_RTOL = 5e-3


@pytest.mark.parametrize("n_classes", [2, 3])
def test_svm_fit_least_squares_matches_reference(n_classes):
    """The app's fit: 32 labelled windows' features through both
    packages' `svm_fit_least_squares`, then `svm_predict` on the other
    32."""
    sig, labels = jbio.synthetic_respiration(64, 2048, seed=3)
    taps = jfir.lowpass_taps(11)
    feats = _np(jax.jit(lambda s: jbio.extract_features(
        jfir.fir_direct(s, taps)))(sig))
    labels = _np(labels) % n_classes
    jw, jb = jbio.svm_fit_least_squares(jnp.asarray(feats[:32]),
                                        jnp.asarray(labels[:32]), n_classes)
    tw, tb = tbio.svm_fit_least_squares(torch.as_tensor(feats[:32]),
                                        torch.as_tensor(labels[:32]),
                                        n_classes)
    assert tw.shape == (12, n_classes) and tb.shape == (n_classes,)
    assert tw.dtype == tb.dtype == torch.float32
    w64, b64 = tbio.svm_fit_least_squares(
        torch.as_tensor(feats[:32]).double(), torch.as_tensor(labels[:32]),
        n_classes)
    for got, want, exact in ((tw, jw, w64), (tb, jb, b64)):
        want, exact = _np(want), exact.numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SVM_FIT_RTOL * np.abs(want).max())
        np.testing.assert_allclose(
            got.numpy(), exact, rtol=0,
            atol=SVM_FIT_F64_RTOL * np.abs(exact).max())
    _, jpred = jbio.svm_predict(jnp.asarray(feats[32:]), jw, jb)
    _, tpred = tbio.svm_predict(torch.as_tensor(feats[32:]), tw, tb)
    np.testing.assert_array_equal(tpred.numpy(), _np(jpred))
