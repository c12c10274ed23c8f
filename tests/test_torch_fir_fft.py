"""The port's standalone FIR and FFT entries (`repro_torch.kernels.fir`,
`repro_torch.kernels.fft`) and the biosignal staged baseline
(`kernels/pipeline/ref.py`) against the JAX package's, on the CPU.

The JAX side runs as `tests/test_fir_rope.py` and `tests/test_fft.py` run
it here: `fir_pallas` and `fft_pallas` in interpret mode, at those tests'
shapes and dtypes. The port's entries get CPU tensors, so they run the
plain PyTorch versions, which the CUDA kernels (`kernels/fir/csrc/fir.cu`,
`kernels/fft/csrc/fft.cu`) are held to on the card. Inputs are drawn with
numpy from a seed; bfloat16 inputs are the same float32 draw rounded to
nearest in both frameworks.

Tolerances, and why:
* FIR: atol = rtol = 1e-5 in float32 (the same taps in the same order,
  XLA may contract an FMA); 0.02 in bfloat16 (one bfloat16 rounding of a
  float32 sum that may differ in its last bit), as `test_fir_rope.py`;
* FFT: 1e-5 of the largest |output| in float32 (the same Stockham stages
  from the same table; XLA may contract an FMA); 5e-2 in bfloat16, as
  `test_fft.py`;
* the staged baselines: the tolerances of `tests/test_torch_pipeline.py`.
Within the port, `fft_plain` equals `core.fft.fft` bitwise: the table and
the per-stage twiddles are the same float32 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.core.fir import lowpass_taps
from repro.kernels.fft.kernel import fft_pallas
from repro.kernels.fft.kernel import twiddle_table as j_twiddle_table
from repro.kernels.fft.ops import rfft as j_rfft
from repro.kernels.fir.kernel import fir_pallas
from repro.kernels.pipeline.ref import pipeline_staged as j_pipeline_staged
from repro.kernels.pipeline.ref import staged_stage_fns as j_stage_fns
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.fft.kernel import fft_plain, twiddle_table
from repro_torch.kernels.fft.ref import fft_ref, rfft_ref
from repro_torch.kernels.fir import ops as fir_ops
from repro_torch.kernels.fir.kernel import fir_plain
from repro_torch.kernels.fir.ref import fir_ref, fir_reference
from repro_torch.kernels.pipeline.ref import (pipeline_staged,
                                              staged_stage_fns)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    """The same float32 draw as a JAX array and a torch tensor of
    ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ------------------------------------------------------------------- FIR

@pytest.mark.parametrize("shape,seq_block", [((4, 512), 128),
                                             ((1, 2048), 512),
                                             ((8, 1024), 1024),
                                             ((2, 256), 256)])
@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fir_matches_reference(shape, seq_block, k, dtype):
    rng = np.random.default_rng(k * 1000 + shape[1])
    jx, tx = _both(rng.normal(size=shape).astype(np.float32), dtype)
    taps = lowpass_taps(k)
    want = fir_pallas(jx, jnp.asarray(taps), seq_block=seq_block)
    got = fir_ops.fir(tx, torch.as_tensor(taps), seq_block=seq_block)
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_fir_runs_over_the_whole_row():
    """One causal filter over each row: zero history only before sample
    0, whatever the tile (the float64 convolution oracle)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 3000)).astype(np.float32)
    taps = lowpass_taps(11)
    got = fir_ops.fir(torch.as_tensor(x), taps, seq_block=700)
    np.testing.assert_allclose(got.numpy(), fir_reference(x, taps),
                               atol=1e-5)
    one = fir_ops.fir(torch.as_tensor(x[1]), taps)             # (S,) form
    assert torch.equal(one, got[1])
    assert torch.equal(fir_plain(torch.as_tensor(x), taps),
                       fir_ref(torch.as_tensor(x), torch.as_tensor(taps)))


def test_fir_refuses_what_it_does_not_take():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir_ops.fir(x.double(), [1.0, -0.97])
    with pytest.raises(ValueError, match="taps"):
        fir_ops.fir(x, np.ones(65, np.float32))
    with pytest.raises(NotImplementedError, match="autotune"):
        fir_ops.fir(x, [1.0], autotune=True)


# ------------------------------------------------------------------- FFT

@pytest.mark.parametrize("n", [8, 64, 512, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fft_matches_reference(n, dtype):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(8, n)) + 1j * rng.normal(size=(8, n))
    jre, tre = _both(x.real.astype(np.float32), dtype)
    jim, tim = _both(x.imag.astype(np.float32), dtype)
    wr, wi = fft_pallas(jre, jim)
    gr, gi = fft_ops.fft(tre, tim)
    assert gr.dtype == tre.dtype and tuple(gr.shape) == (8, n)
    tol = 1e-5 if dtype == "float32" else 5e-2
    scale = max(np.abs(_f32(wr)).max(), np.abs(_f32(wi)).max())
    for g, w in ((gr, wr), (gi, wi)):
        assert np.abs(_f32(g) - _f32(w)).max() <= tol * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inverse_fft_matches_reference(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    y = rng.normal(size=(4, 256)).astype(np.float32)
    (jre, tre), (jim, tim) = _both(x, dtype), _both(y, dtype)
    wr, wi = fft_pallas(jre, jim, inverse=True)
    gr, gi = fft_ops.fft(tre, tim, inverse=True)
    tol = 1e-5 if dtype == "float32" else 5e-2
    scale = max(np.abs(_f32(wr)).max(), np.abs(_f32(wi)).max())
    for g, w in ((gr, wr), (gi, wi)):
        assert np.abs(_f32(g) - _f32(w)).max() <= tol * scale
    # the round trip, as test_fft.py's
    fr, fi = fft_ops.fft(torch.as_tensor(x))
    br, bi = fft_ops.fft(fr, fi, inverse=True)
    np.testing.assert_allclose(br.numpy(), x, atol=2e-5)
    np.testing.assert_allclose(bi.numpy(), 0, atol=2e-5)


@pytest.mark.parametrize("n", [64, 512, 2048])
def test_rfft_matches_reference(n):
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    wr, wi = j_rfft(jnp.asarray(x))
    gr, gi = fft_ops.rfft(torch.as_tensor(x))
    assert tuple(gr.shape) == (2, n // 2 + 1)
    scale = np.abs(np.asarray(wr)).max()
    for g, w in ((gr, wr), (gi, wi)):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * scale
    ref = np.fft.rfft(x)
    err = np.abs((gr.numpy() + 1j * gi.numpy()) - ref).max()
    assert err / np.abs(ref).max() < 1e-4


@pytest.mark.parametrize("n", [8, 256, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_plain_is_the_core_stockham_chain(n, inverse):
    rng = np.random.default_rng(n + inverse)
    re = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32))
    im = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32))
    for mine, ref in zip(twiddle_table(n, inverse),
                         j_twiddle_table(n, inverse)):
        np.testing.assert_array_equal(mine, ref)
    got = fft_plain(re, im, inverse=inverse)
    want = fft_ref(re, im, inverse=inverse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if not inverse:
        x = re[:, :n]
        assert all(torch.equal(g, w) for g, w in
                   zip(fft_ops.rfft(x), rfft_ref(x)))


def test_fft_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="power of 2"):
        fft_ops.fft(torch.zeros(2, 12))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fft_ops.fft(torch.zeros(2, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="one shape"):
        fft_ops.fft(torch.zeros(2, 16), torch.zeros(3, 16))
    with pytest.raises(NotImplementedError, match="autotune"):
        fft_ops.fft(torch.zeros(2, 16), autotune=True)


# ------------------------------------------------- biosignal staged baseline

@pytest.fixture(scope="module")
def bio():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    frames = np.asarray(j_synth(6, 2048, seed=4)[0])
    return japp, app, frames


def _assert_app_outputs(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k == "class":
            np.testing.assert_array_equal(g, w)
        elif k == "filtered":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        elif k == "features":
            np.testing.assert_array_equal(g[..., :6], w[..., :6])
            np.testing.assert_allclose(g[..., 6:], w[..., 6:], rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def test_pipeline_staged_matches_reference(bio):
    japp, app, frames = bio
    want = j_pipeline_staged(frames, japp.fir_taps, japp.svm_w, japp.svm_b)
    got = pipeline_staged(torch.as_tensor(frames), app.fir_taps, app.svm_w,
                          app.svm_b)
    _assert_app_outputs(got, want)
    # and the staged app itself, which is its oracle
    _assert_app_outputs(got, {k: v.numpy() for k, v in
                              app(torch.as_tensor(frames)).items()})


def test_staged_stage_fns_match_reference(bio):
    japp, app, frames = bio
    jf, jfeat, jsvm = j_stage_fns(japp.fir_taps, japp.svm_w, japp.svm_b)
    tf, tfeat, tsvm = staged_stage_fns(app.fir_taps, app.svm_w, app.svm_b)
    jfilt = jf(frames)
    tfilt = tf(torch.as_tensor(frames))
    jfe, tfe = jfeat(jfilt), tfeat(tfilt)
    (jm, jc), (tm, tc) = jsvm(jfe), tsvm(tfe)
    _assert_app_outputs({"filtered": tfilt, "features": tfe, "margin": tm,
                         "class": tc},
                        {"filtered": jfilt, "features": jfe, "margin": jm,
                         "class": jc})
