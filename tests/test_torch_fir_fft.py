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

The last section checks the host side of the FFT kernel, which itself
runs only on a card (`tests/test_torch_kernel.py`): its twiddle table
against float64 cos/sin cast to float32, and its decomposition, walked
through in numpy with the kernel's radix passes, thread-to-point map and
table, against `fft_plain` within `FFT_TOL`, so that a layout fault shows
without a card. `FFT_TOL` must also flag a transform with one stage's
twiddles conjugated, in both dtypes.
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
from repro_torch.core.fft import fft_stages
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.fft.kernel import (FFT_TOL, MAX_N, MAX_THREADS,
                                            ROW_MAX_N, default_block_rows,
                                            fft_cuda,
                                            fft_plain, stockham_plan,
                                            stockham_table, threads_per_row,
                                            twiddle_table)
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
    """What the entry refuses on the CPU, as on the card: a complex or
    boolean input, taps that are not a non-empty vector, a rank other
    than 1 or 2. Any tap count and every real dtype of the reference
    filter (`tests/test_torch_kernel_reach.py`); autotune is ported."""
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="real input"):
        fir_ops.fir(x.to(torch.complex64), [1.0, -0.97])
    with pytest.raises(ValueError, match="real input"):
        fir_ops.fir(x.bool(), [1.0, -0.97])
    with pytest.raises(ValueError, match="taps"):
        fir_ops.fir(x, np.ones(0, np.float32))
    with pytest.raises(ValueError, match="taps"):
        fir_ops.fir(x, np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match=r"\(R, S\)"):
        fir_ops.fir(torch.zeros(2, 2, 64), [1.0])
    # autotune is ported: a tuned call equals the untuned one bitwise
    y = torch.randn(3, 700, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fir_ops.fir(y, [1.0, 0.5], autotune=True),
                       fir_ops.fir(y, [1.0, 0.5]))


@pytest.mark.parametrize("k", [65, 129])
def test_fir_past_the_kernel_tap_cap_matches_reference(k):
    """More taps than the card kernel's 64 filter on the CPU as the
    reference's `fir_pallas` filters them (ROADMAP C.1)."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    taps = rng.normal(size=k).astype(np.float32) / k
    want = fir_pallas(jnp.asarray(x), jnp.asarray(taps))
    got = fir_ops.fir(torch.as_tensor(x), torch.as_tensor(taps))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,want_dtype", [
    (np.float64, np.float32),      # 64-bit types off: float32 both sides
    (np.float16, np.float16),
    (np.int32, np.int32)])
def test_fir_other_dtypes_match_reference(dtype, want_dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 512)) * 40).astype(dtype)
    taps = lowpass_taps(11)
    want = np.asarray(fir_pallas(jnp.asarray(x), jnp.asarray(taps)))
    got = fir_ops.fir(torch.as_tensor(x), torch.as_tensor(taps)).numpy()
    assert want.dtype == want_dtype and got.dtype == want_dtype
    if dtype == np.int32:       # one float32 rounding may cross an integer
        assert np.abs(got.astype(np.int64) - want).max() <= 1
    else:
        tol = 1e-5 if dtype == np.float64 else 2e-2
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=tol,
                                   rtol=tol)


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
    """What the entry refuses: a length that is not a power of 2, planes
    of two shapes and an integer dtype. float64 planes are narrowed to
    float32 first, as the reference stages them, and compute."""
    with pytest.raises(ValueError, match="power of 2"):
        fft_ops.fft(torch.zeros(2, 12))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fft_ops.fft(torch.zeros(2, 16, dtype=torch.int32))
    x64 = torch.randn(2, 16, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    got = fft_ops.fft(x64)
    assert all(g.dtype == torch.float32 for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, fft_ops.fft(x64.float())))
    with pytest.raises(ValueError, match="one shape"):
        fft_ops.fft(torch.zeros(2, 16), torch.zeros(3, 16))
    # autotune is ported: a tuned call equals the untuned one bitwise
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        fft_ops.fft(x, autotune=True), fft_ops.fft(x)))


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


# ------------------------------------------ the FFT kernel's host side

SIZES = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]


def _plan(n: int) -> list:
    """(radix, span) per pass: radix 16 while it fits, then the rest."""
    passes, span, left = [], 1, n
    while left > 1:
        radix = min(16, left)
        passes.append((radix, span))
        span, left = span * radix, left // radix
    return passes


@pytest.mark.parametrize("n", SIZES)
def test_plan_and_threads(n):
    assert list(stockham_plan(n)) == _plan(n)
    assert threads_per_row(n) * min(n, 16) == n
    assert default_block_rows(n) * threads_per_row(n) <= MAX_THREADS


@pytest.mark.parametrize("n", SIZES)
def test_stockham_table_is_float64_cos_sin_cast_once(n):
    table = stockham_table(n)
    want = []
    for radix, span in _plan(n):
        if span == 1:
            continue
        for j in range(radix):
            for k in range(span):
                a = -2.0 * np.pi * j * k / (span * radix)
                want.append((np.cos(a), np.sin(a)))
    want = np.asarray(want, np.float64).reshape(-1, 2).astype(np.float32)
    assert table.dtype == np.float32 and table.shape == want.shape
    np.testing.assert_array_equal(table, want)


def walk_through(re: np.ndarray, im: np.ndarray, inverse: bool) -> tuple:
    """The kernel's arithmetic in numpy: T = N / E threads a row, thread i
    holding points i + T m (m < E = min(N, 16)); each pass's DFT number b
    = i + T u twiddles its point j by table[offset + j * Ns + k], k = b mod
    Ns, and writes output r to (b - k) R + k + r Ns. The inverse swaps re
    and im on the way in and out and scales by 1/N."""
    if inverse:
        re, im = im, re
    rows, n = re.shape
    x = (re + 1j * im).astype(np.complex64)
    E = min(n, 16)
    T = n // E
    table = stockham_table(n)
    w = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
    i = np.arange(T)
    offset = 0
    for radix, span in stockham_plan(n):
        held = x[:, i[:, None] + T * np.arange(E)[None, :]]   # (rows, T, E)
        out = np.zeros_like(x)
        written = np.zeros(n, int)
        for u in range(E // radix):
            b = i + T * u
            k = b & (span - 1)
            y = held[:, :, u + np.arange(radix) * (E // radix)]
            if span > 1:
                y = y * w[offset + np.arange(radix)[None, :] * span +
                          k[:, None]]
            y = np.fft.fft(y, axis=-1).astype(np.complex64)
            dest = ((b - k) * radix + k)[:, None] + \
                np.arange(radix)[None, :] * span
            out[:, dest] = y
            np.add.at(written, dest.ravel(), 1)
        assert (written == 1).all(), "a pass must write every point once"
        x = out
        if span > 1:
            offset += radix * span
    assert offset == len(table)
    if inverse:
        x = x * np.float32(1.0 / n)
        return x.imag.astype(np.float32), x.real.astype(np.float32)
    return x.real.astype(np.float32), x.imag.astype(np.float32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 16, 256, 4096, 8192])
def test_walk_through_gives_the_fft(n, inverse):
    rng = np.random.default_rng(n + inverse)
    re = rng.normal(size=(3, n)).astype(np.float32)
    im = rng.normal(size=(3, n)).astype(np.float32)
    got = walk_through(re, im, inverse)
    want = fft_plain(torch.as_tensor(re), torch.as_tensor(im),
                     inverse=inverse)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() <= FFT_TOL["float32"] * scale
    ref = (np.fft.ifft if inverse else np.fft.fft)(re + 1j * im, axis=-1)
    np.testing.assert_allclose(got[0] + 1j * got[1], ref,
                               atol=FFT_TOL["float32"] * scale)


def register_dft(x: np.ndarray) -> np.ndarray:
    """`dft<R>` of the source over the last axis: R <= 4 directly; else R =
    A B (A = 4, or 2 for R = 8), A-point DFTs over x[B n1 + n2], twiddles
    w_R^(n2 k1), B-point DFTs, output k1 + A k2."""
    R = x.shape[-1]
    if R <= 4:
        return np.fft.fft(x, axis=-1)
    A = 2 if R == 8 else 4
    B = R // A
    y = register_dft(x.reshape(*x.shape[:-1], A, B).swapaxes(-1, -2))
    y = y * np.exp(-2j * np.pi * np.outer(np.arange(B), np.arange(A)) / R)
    z = register_dft(y.swapaxes(-1, -2))           # (..., k1, k2)
    return z.swapaxes(-1, -2).reshape(*x.shape)    # index k1 + A k2


@pytest.mark.parametrize("radix", [2, 4, 8, 16])
def test_register_dft_decomposition(radix):
    x = np.random.default_rng(radix).normal(size=(5, radix, 2)) @ [1, 1j]
    np.testing.assert_allclose(register_dft(x), np.fft.fft(x, axis=-1),
                               atol=1e-12)


def conjugated_stage(re: torch.Tensor, im: torch.Tensor, *, stage: int = 0,
                     inverse: bool = False) -> tuple:
    """The plain chain with stage ``stage``'s twiddles conjugated, rounded
    to the input's dtype as the kernel's output is."""
    n = re.shape[-1]
    wr, wi = (torch.as_tensor(a) for a in twiddle_table(n, inverse))
    wi = wi.clone()
    wi[stage] = -wi[stage]
    rr, ri = fft_stages(re.float(), im.float(), table=(wr, wi))
    if inverse:
        rr, ri = rr / n, ri / n
    return rr.to(re.dtype), ri.to(re.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,inverse", [(8, False), (256, False),
                                       (256, True), (2048, True)])
def test_fft_tol_flags_a_conjugated_stage(dtype, n, inverse):
    rng = np.random.default_rng(n)
    td = getattr(torch, dtype)
    re = torch.as_tensor(rng.normal(size=(16, n)).astype(np.float32)).to(td)
    im = torch.as_tensor(rng.normal(size=(16, n)).astype(np.float32)).to(td)
    want = fft_plain(re, im, inverse=inverse)
    wrong = conjugated_stage(re, im, inverse=inverse)
    scale = max(float(w.float().abs().max()) for w in want)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(wrong, want))
    assert diff > FFT_TOL[dtype] * scale


def test_fft_tol_values():
    """1e-4 in float32; one bfloat16 step (2^-7) fits under 1e-2, one
    float16 step (2^-10) under 2e-3."""
    assert FFT_TOL == {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
    assert 2.0 ** -7 < FFT_TOL["bfloat16"]
    assert 2.0 ** -10 < FFT_TOL["float16"]


def test_fft_cuda_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        fft_cuda(torch.zeros(2, 16), torch.zeros(2, 16))
    with pytest.raises(ValueError, match="power of 2"):
        fft_cuda(torch.zeros(2, 12), torch.zeros(2, 12))
    # one launch up to 8192 points, the four-step transform up to 2^26
    assert ROW_MAX_N == 8192 and MAX_N == 1 << 26
