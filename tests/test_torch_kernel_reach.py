"""The sizes and dtypes the reference's FFT, FIR and graph kernels take,
through the port's entries against the JAX package's, on the CPU.

The JAX side runs as its own tests run it here: `fft_pallas`,
`fir_pallas`, the flash-attention and RoPE entries and the `ops.py` graph
entries in interpret mode. The port's entries get CPU tensors and run the
plain PyTorch versions, which the CUDA kernels are held to on the card
(`tests/test_torch_kernel.py`, `chip_smoke.py`). Inputs are drawn with
numpy from a seed.

What is compared, and why:
* an integer FIR at full scale: both packages compute in float32 and
  store as ``astype`` does (truncate, saturate, NaN to 0), so the rails
  are exact and elsewhere the outputs are apart by at most 1 more than
  the two float32 filters are (XLA may contract an FMA: below 1 up to
  int16's scale, a few float32 steps at int32's);
* float16 (FFT, attention, RoPE): both compute in float32 and round once
  to float16, so at most one float16 step apart (2^-10 of the value)
  plus the float32 difference: the FFT within ``FFT_TOL["float16"]`` of
  the largest |output|, attention within ``FLASH_TOL["float16"]`` per
  element, RoPE within 2^-10 |want| + 1e-4 max |x| (the float32 rule of
  `tests/test_torch_rope.py` plus one rounding);
* float64 planes: the reference's ``jnp.asarray`` narrows them to
  float32, so the port's float32 result within 1e-5 of the largest
  |output|, as `tests/test_torch_fir_fft.py`'s float32 FFT;
* the FFT past 8192 points and the FIR past 64 taps: the float32
  tolerances of `tests/test_torch_fir_fft.py` (1e-5 of the largest
  |output|; atol = rtol = 1e-5);
* the graphs on int8 and uint8 signals: the rules of
  `tests/test_torch_graph_dtypes.py` for int16 and int32.

The last section walks the FFT kernel's four-step transform (N past
8192) through in numpy with the kernel's own line, block and address
arithmetic and its host table, against `fft_plain`, so that a fault in
that arithmetic shows without a card.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.core.fir import lowpass_taps
from repro.kernels.fft.kernel import fft_pallas
from repro.kernels.fir.kernel import fir_pallas
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.pipeline import ops as jops
from repro.kernels.pipeline.asr import make_asr_frontend as j_asr_frontend
from repro.kernels.rope.ops import rope as j_rope
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels import cast_output
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.fft.kernel import (FFT_TOL, MAX_N, ROW_MAX_N,
                                            four_step_model, four_step_plan,
                                            four_step_table,
                                            four_step_twiddles, fft_plain,
                                            stockham_table)
from repro_torch.kernels.fir import ops as fir_ops
from repro_torch.kernels.fir.kernel import fir_plain
from repro_torch.kernels.flash_attention.kernel import FLASH_TOL
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.pipeline import ops
from repro_torch.kernels.pipeline.asr import make_asr_frontend
from repro_torch.kernels.rope.ops import rope
from repro_torch.serve.resident import ResidentConfig, ResidentStream
from repro_torch.serve.stream import BiosignalStream, StreamConfig

INT_DTYPES = {"int8": (torch.int8, np.int8), "uint8": (torch.uint8, np.uint8),
              "int16": (torch.int16, np.int16),
              "int32": (torch.int32, np.int32)}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _at_full_scale(x: np.ndarray, dname: str) -> np.ndarray:
    """``x`` at the integer dtype's full scale: scaled to half the range
    about its middle, plus a square wave of period 74 at the other half,
    rounded and clipped into the range (the filters below pass the range
    at the square's edges)."""
    info = np.iinfo(np.dtype(dname))
    mid, half = (info.max + info.min) / 2.0, (info.max - info.min) / 2.0
    x = 0.5 * x / np.abs(x).max()
    square = np.where((np.arange(x.shape[-1]) // 37) % 2 == 0, 0.5, -0.5)
    return np.clip(np.round(mid + (x + square) * 2.0 * half), info.min,
                   info.max).astype(dname)


def _full_scale_rows(dname: str, shape, seed: int) -> np.ndarray:
    """Integer rows at full scale from a normal draw."""
    return _at_full_scale(np.random.default_rng(seed).normal(size=shape),
                          dname)


# ------------------------------------------------ FIR on integer rows

@pytest.mark.parametrize("taps", ["gain", "lowpass"])
@pytest.mark.parametrize("dname", list(INT_DTYPES))
def test_fir_integer_rows_saturate_as_the_reference(dname, taps):
    """Integer rows at full scale through three taps of 1.5 (a gain of
    4.5: most outputs pass the range) and an 11-tap low-pass (overshoot
    at the edges): the rails exact, elsewhere within 1 more than the two
    float32 filters differ. A wrapping store (``.to``) fails here."""
    tdt, ndt = INT_DTYPES[dname]
    x = _full_scale_rows(dname, (3, 1024), seed=len(dname))
    h = np.full(3, 1.5, np.float32) if taps == "gain" else lowpass_taps(11)
    want = np.asarray(fir_pallas(jnp.asarray(x), jnp.asarray(h)))
    got = fir_ops.fir(torch.as_tensor(x), torch.as_tensor(h))
    assert got.dtype == tdt and want.dtype == ndt
    g, w = got.numpy().astype(np.int64), want.astype(np.int64)
    info = np.iinfo(ndt)
    rails = (w == info.max) | (w == info.min)
    assert rails.sum() > 20, "the filter must pass the range"
    np.testing.assert_array_equal(g[rails], w[rails])
    # the two float32 filters of the same values
    wide_t = fir_plain(torch.as_tensor(x).float(), torch.as_tensor(h))
    wide_j = np.asarray(fir_pallas(jnp.asarray(x.astype(np.float32)),
                                   jnp.asarray(h)))
    gap = np.abs(wide_t.numpy().astype(np.float64) - wide_j)
    assert (np.abs(g - w) <= np.floor(gap) + 1).all()
    if dname != "int32":      # float32 is exact enough at 8- and 16-bit scale
        assert np.abs(g - w).max() <= 1
    assert not torch.equal(got, wide_t.to(tdt))     # a wrap would differ


def test_fir_integer_rows_equal_the_float32_filter_cast():
    """Within the port an integer FIR is the float32 FIR of the widened
    rows, stored by `cast_output` (NaN to 0, saturated, truncated)."""
    for dname, (tdt, _) in INT_DTYPES.items():
        x = torch.as_tensor(_full_scale_rows(dname, (2, 700), seed=3))
        h = lowpass_taps(11)
        assert torch.equal(fir_plain(x, h),
                           cast_output(fir_plain(x.float(), h), tdt))


# ------------------------------------------ float16 and float64 repairs

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [64, 2048])
def test_fft_float16_matches_reference(n, inverse):
    rng = np.random.default_rng(n + inverse)
    re = rng.normal(size=(6, n)).astype(np.float16)
    im = rng.normal(size=(6, n)).astype(np.float16)
    want = fft_pallas(jnp.asarray(re), jnp.asarray(im), inverse=inverse)
    got = fft_ops.fft(torch.as_tensor(re), torch.as_tensor(im),
                      inverse=inverse)
    assert all(g.dtype == torch.float16 for g in got)
    assert all(np.asarray(w).dtype == np.float16 for w in want)
    scale = max(np.abs(_f32(w)).max() for w in want)
    for g, w in zip(got, want):
        assert np.abs(_f32(g) - _f32(w)).max() <= \
            FFT_TOL["float16"] * scale


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_float64_is_narrowed_as_the_reference(inverse):
    rng = np.random.default_rng(11)
    re, im = rng.normal(size=(2, 4, 512))
    want = fft_pallas(jnp.asarray(re), jnp.asarray(im), inverse=inverse)
    got = fft_ops.fft(torch.as_tensor(re), torch.as_tensor(im),
                      inverse=inverse)
    assert all(g.dtype == torch.float32 for g in got)
    assert all(np.asarray(w).dtype == np.float32 for w in want)
    scale = max(np.abs(_f32(w)).max() for w in want)
    for g, w in zip(got, want):
        assert np.abs(_f32(g) - _f32(w)).max() <= 1e-5 * scale


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_flash_float16_matches_reference(causal, window):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=s).astype(np.float16)
               for s in ((1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64)))
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                   window=window, q_chunk=64, kv_chunk=64)
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          causal=causal, window=window, q_chunk=64,
                          kv_chunk=64)
    assert got.dtype == torch.float16
    atol, rtol = FLASH_TOL["float16"]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("layout", ["interleaved", "neox"])
def test_rope_float16_matches_reference(layout):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(96, 64)).astype(np.float16)
    pos = rng.integers(0, 512, 96).astype(np.int32)
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4, layout=layout)
    got = rope(torch.as_tensor(x), torch.as_tensor(pos), theta=1e4,
               layout=layout)
    assert got.dtype == torch.float16
    g, w = _f32(got), _f32(want)
    scale = float(np.abs(x.astype(np.float32)).max())
    assert (np.abs(g - w) <= 2.0 ** -10 * np.abs(w) + 1e-4 * scale).all()


def test_float16_on_the_card_waits_for_its_kernels():
    """Attention and RoPE take float16 on the CPU; their kernels raise on
    it, naming what they take (the check needs no card: a CPU tensor is
    refused first for its device, so the dtype lists are pinned here)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rope import kernel as rk

    assert torch.float16 not in fk.DTYPES and torch.float16 in \
        fk.PLAIN_DTYPES
    assert torch.float16 not in rk.DTYPES and torch.float16 in \
        rk.PLAIN_DTYPES


# ---------------------------------------- the FFT past 8192 points

@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("n", [16384, 65536])
def test_fft_past_8192_matches_reference(n, dtype):
    rng = np.random.default_rng(n)
    re, im = (rng.normal(size=(2, n)).astype(dtype) for _ in range(2))
    tol = 1e-5 if dtype == "float32" else FFT_TOL["float16"]
    for inverse in (False, True):
        got = fft_ops.fft(torch.as_tensor(re), torch.as_tensor(im),
                          inverse=inverse)
        assert all(g.dtype == getattr(torch, dtype) for g in got)
        if dtype == "float16" and inverse and n > 65504:
            # the reference divides its float16 result by N in float16,
            # where N = 65536 is inf: its inverse is 0. Hold the port's to
            # numpy's in float64 instead.
            z = np.fft.ifft(re.astype(np.float64) + 1j * im, axis=-1)
            want = (z.real, z.imag)
        else:
            want = fft_pallas(jnp.asarray(re), jnp.asarray(im),
                              inverse=inverse)
        scale = max(np.abs(_f32(w)).max() for w in want)
        for g, w in zip(got, want):
            assert np.abs(_f32(g) - _f32(w)).max() <= tol * scale


def test_rfft_past_8192_matches_numpy():
    """The packed real FFT of 2^15 samples (a 2^14-point complex row)
    against numpy's, in float32."""
    x = np.random.default_rng(2).normal(size=(2, 1 << 15)).astype(np.float32)
    gr, gi = fft_ops.rfft(torch.as_tensor(x))
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    scale = np.abs(want).max()
    assert np.abs(gr.numpy() - want.real).max() <= 1e-5 * scale
    assert np.abs(gi.numpy() - want.imag).max() <= 1e-5 * scale


# ---------------------------------------- the FIR past 64 taps

@pytest.mark.parametrize("k", [65, 127, 255, 2048])
def test_fir_past_64_taps_matches_reference(k):
    rng = np.random.default_rng(k)
    S = 4096 if k == 2048 else 2048
    x = rng.normal(size=(2, S)).astype(np.float32)
    taps = (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)
    want = fir_pallas(jnp.asarray(x), jnp.asarray(taps))
    got = fir_ops.fir(torch.as_tensor(x), torch.as_tensor(taps))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dname", ["float16", "int8", "uint8", "int16"])
def test_fir_past_64_taps_on_other_dtypes(dname):
    """127 taps on 16- and 8-bit rows: the reference's values, the 16-bit
    float within 2e-2 (one rounding of a float32 sum that may differ in
    its last bit, as `tests/test_torch_fir_fft.py`), the integers as
    `test_fir_integer_rows_saturate_as_the_reference`."""
    rng = np.random.default_rng(127)
    taps = lowpass_taps(127, cutoff=0.05)
    if dname == "float16":
        x = rng.normal(size=(2, 2048)).astype(np.float16)
    else:
        x = _full_scale_rows(dname, (2, 2048), seed=5)
    want = np.asarray(fir_pallas(jnp.asarray(x), jnp.asarray(taps)))
    got = fir_ops.fir(torch.as_tensor(x), torch.as_tensor(taps)).numpy()
    assert got.dtype == want.dtype == x.dtype
    if dname == "float16":
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=2e-2,
                                   rtol=2e-2)
    else:
        assert np.abs(got.astype(np.int64) - want).max() <= 1


# ------------------------------------------ 8-bit signals in both graphs

WINDOW, N_FRAMES = 512, 6
GRAPHS = {"biosignal": 128, "asr": 160}          # graph -> hop
BYTE_DTYPES = {"int8": (torch.int8, jnp.int8), "uint8": (torch.uint8,
                                                         jnp.uint8)}


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return {"biosignal": (japp, app),
            "asr": (j_asr_frontend(), make_asr_frontend(device="cpu"))}


def _byte_signal(name: str, hop: int, dname: str) -> torch.Tensor:
    """The graph's signal at the 8-bit dtype's full scale."""
    n = (N_FRAMES - 1) * hop + WINDOW
    base = np.asarray(j_synth(1, n, seed=4)[0][0]) if name == "biosignal" \
        else np.random.default_rng(4).standard_normal(n)
    return torch.as_tensor(_at_full_scale(base, dname))


def _entry_input(hop: int, entry: str, x: np.ndarray) -> np.ndarray:
    if entry == "stream":
        return x
    if entry == "frames":
        return np.stack([x[f * hop: f * hop + WINDOW]
                         for f in range(N_FRAMES)])
    span = 2 * hop + WINDOW
    return np.stack([x[:span], x[3 * hop: 3 * hop + span]])


def _call(pkg, name, app, x, hop, entry):
    if entry == "stream":
        return pkg.graph_pipeline_stream(name, app, x, window=WINDOW, hop=hop)
    if entry == "frames":
        return pkg.graph_pipeline(name, app, x)
    return pkg.graph_pipeline_ring(name, app, x, window=WINDOW, hop=hop)


def _rows(out: dict) -> dict:
    """Numpy per-frame rows: a ring's (D, n, ...) outputs as (D * n,
    ...)."""
    rows = {}
    for k, v in out.items():
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        rows[k] = a.reshape((N_FRAMES,) + a.shape[a.ndim - (k != "class"):])
    return rows


@pytest.mark.parametrize("entry", ["stream", "frames", "ring"])
@pytest.mark.parametrize("dname", list(BYTE_DTYPES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_byte_signal_entry_matches_reference(apps, name, dname, entry):
    """An int8 or uint8 signal near full scale at every entry: class and
    features[:, :6] exact, ``filtered`` in the signal's dtype within 1
    (exact where the two float32 filters agree) and at the rails where
    the reference saturates, the rest within the float32 tolerances of
    `tests/test_torch_pipeline.py` and `tests/test_torch_asr.py`."""
    japp, app = apps[name]
    hop = GRAPHS[name]
    tdt, jdt = BYTE_DTYPES[dname]
    x = _byte_signal(name, hop, dname).numpy()
    tin = torch.as_tensor(_entry_input(hop, entry, x))
    want = _call(jops, name, japp, jnp.asarray(tin.numpy()), hop, entry)
    got = _call(ops, name, app, tin, hop, entry)
    assert got["filtered"].dtype == tdt
    assert np.asarray(want["filtered"]).dtype == np.dtype(jdt)
    g, w = _rows(got), _rows(want)
    info = np.iinfo(np.dtype(dname))
    gf, wf = g.pop("filtered").astype(np.int64), w.pop("filtered")
    assert (wf == info.min).any(), "the filter must pass the range"
    rails = (wf == info.max) | (wf == info.min)
    np.testing.assert_array_equal(gf[rails], wf[rails])
    assert np.abs(gf - wf).max() <= 1
    if name == "biosignal":
        np.testing.assert_array_equal(g["class"], w["class"])
        np.testing.assert_array_equal(g["features"][..., :6],
                                      w["features"][..., :6])
        np.testing.assert_allclose(g["features"], w["features"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g["margin"], w["margin"], rtol=1e-5,
                                   atol=1e-4)
    else:
        # logmel at 8-bit PCM scale: the float32 rounding of sums about
        # 2^8 times those of audio in [-1, 1], so relative to the largest
        scale = float(np.abs(w["logmel"]).max())
        assert np.abs(g["logmel"] - w["logmel"]).max() <= 1e-5 * scale


@pytest.mark.parametrize("dname", list(BYTE_DTYPES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_byte_signal_equals_float32_on_the_widened_signal(apps, name, dname):
    """An 8-bit call is the float32 call on the widened signal,
    ``filtered`` cast as the reference's astype casts (a wrapping cast
    would differ)."""
    _, app = apps[name]
    hop = GRAPHS[name]
    tdt, _ = BYTE_DTYPES[dname]
    x = _byte_signal(name, hop, dname)
    got = ops.graph_pipeline_stream(name, app, x, window=WINDOW, hop=hop)
    want = ops.graph_pipeline_stream(name, app, x.float(), window=WINDOW,
                                     hop=hop)
    for k, v in want.items():
        assert torch.equal(got[k], cast_output(v, tdt) if k == "filtered"
                           else v), k
    assert not torch.equal(got["filtered"], want["filtered"].to(tdt))


@pytest.mark.parametrize("dname", list(BYTE_DTYPES))
def test_byte_signal_stream_runtimes_equal_one_call(apps, dname):
    """The stream, the host-framed stream and the resident ring keep the
    8-bit signal and give the one call's bits."""
    _, app = apps["biosignal"]
    x = _byte_signal("biosignal", 128, dname).repeat(3)
    want = ops.app_pipeline_stream(app, x, window=WINDOW, hop=128)
    cfg = StreamConfig(window=WINDOW, hop=128, batch_windows=4)
    for run in (BiosignalStream(app, cfg),
                BiosignalStream(app, StreamConfig(
                    window=WINDOW, hop=128, batch_windows=4,
                    framing="host")),
                ResidentStream(app, cfg, ResidentConfig(ring_depth=2))):
        got = run.process(x)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# ----------------------------- the four-step transform, walked through

_FFT_CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "fft" / "csrc" / "fft.cu"


def _cu_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _FFT_CU.read_text()).group(1))


@pytest.mark.parametrize("n,plan", [(16384, (128, 128)),
                                    (32768, (256, 128)),
                                    (1 << 20, (1024, 1024)),
                                    (1 << 21, (2048, 1024)),
                                    (1 << 26, (8192, 8192))])
def test_four_step_plan(n, plan):
    assert four_step_plan(n) == plan
    n1, n2 = plan
    assert n1 * n2 == n and n2 <= n1 <= ROW_MAX_N


def test_four_step_bounds_match_the_source():
    assert ROW_MAX_N == 1 << _cu_const("kMaxLog")
    assert MAX_N == 1 << _cu_const("kMaxFourStepLog")
    assert _cu_const("kFourStepPoints") == ROW_MAX_N


@pytest.mark.parametrize("n", [1 << 14, 1 << 20, 1 << 26])
def test_four_step_twiddles_are_float64_cast_once(n):
    n1, n2 = four_step_plan(n)
    fine, coarse = four_step_twiddles(n)
    j = np.arange(n1)
    np.testing.assert_array_equal(fine[:, 0], np.cos(-2 * np.pi * j / n)
                                  .astype(np.float32))
    np.testing.assert_array_equal(fine[:, 1], np.sin(-2 * np.pi * j / n)
                                  .astype(np.float32))
    j = np.arange(n2)
    np.testing.assert_array_equal(coarse[:, 0], np.cos(-2 * np.pi * j * n1 /
                                                       n).astype(np.float32))
    # the product W_N^e = coarse[e // N1] fine[e % N1] over a sample of e,
    # against float64: two roundings of 2^-24 each, and the product's
    e = np.random.default_rng(0).integers(0, n, 4096)
    w = (coarse[e // n1] @ [1, 1j]) * (fine[e % n1] @ [1, 1j])
    assert np.abs(w - np.exp(-2j * np.pi * e / n)).max() < 4e-7


def four_step_walk(re: np.ndarray, im: np.ndarray, inverse: bool) -> tuple:
    """The kernel's two passes in numpy: blocks of 8192 points, LINES =
    8192 / L lines each, line l of block b the global line L = b LINES +
    l; the kernel's base, c0 and address arithmetic for every point;
    line transforms by `fft_plain`; the inter-pass factor from the host
    table at the kernel's offsets, coarse[e >> lg1] fine[e & (N1 - 1)]."""
    if inverse:
        re, im = im, re
    R, n = re.shape
    lg = n.bit_length() - 1
    lg1, lg2 = (lg + 1) // 2, lg // 2
    table = four_step_table(n)
    t1, t2 = len(stockham_table(1 << lg1)), len(stockham_table(1 << lg2))
    fine = table[t1 + t2: t1 + t2 + (1 << lg1)] @ [1, 1j]
    coarse = table[t1 + t2 + (1 << lg1):] @ [1, 1j]
    assert len(coarse) == 1 << lg2
    points = _cu_const("kFourStepPoints")
    src = (re + 1j * im).astype(np.complex64).ravel()

    def one_pass(data, LG, lg_lines, second):
        lines = points >> LG
        n_lines = R << lg_lines
        L = np.arange(n_lines)[:, None]                # global line
        line0 = (L // lines) * lines
        base = (line0 >> lg_lines) << (LG + lg_lines)
        c0 = line0 & ((1 << lg_lines) - 1)
        l = L - line0
        p = np.arange(1 << LG)[None, :]
        if second:                      # in: q = l L + p past the block's
            g_in = base + (c0 << LG) + (l << LG) + p
        else:
            g_in = base + (p << lg_lines) + c0 + l
        x = data[g_in]
        yr, yi = fft_plain(torch.as_tensor(x.real.copy()),
                           torch.as_tensor(x.imag.copy()))
        y = (yr.numpy() + 1j * yi.numpy()).astype(np.complex64)
        out = np.zeros(R * n, np.complex64)
        hits = np.zeros(R * n, int)
        if second:
            g_out = base + c0 + l + (p << lg_lines)
        else:
            e = (c0 + l) * p
            assert e.max() < n
            y = y * (coarse[e >> LG] * fine[e & ((1 << LG) - 1)])
            g_out = base + (p << lg_lines) + c0 + l
        out[g_out] = y
        np.add.at(hits, g_out.ravel(), 1)
        assert (hits == 1).all(), "a pass writes every point once"
        return out

    mid = one_pass(src, lg1, lg2, False)
    x = one_pass(mid, lg2, lg1, True).reshape(R, n)
    if inverse:
        x = x / n
        return x.imag.astype(np.float32), x.real.astype(np.float32)
    return x.real.astype(np.float32), x.imag.astype(np.float32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_four_step_walk_through_gives_the_fft(n, inverse):
    rng = np.random.default_rng(n + inverse)
    re, im = (rng.normal(size=(2, n)).astype(np.float32) for _ in range(2))
    want = fft_plain(torch.as_tensor(re), torch.as_tensor(im),
                     inverse=inverse)
    scale = max(float(w.abs().max()) for w in want)
    for got in (four_step_walk(re, im, inverse),
                four_step_model(torch.as_tensor(re), torch.as_tensor(im),
                                inverse=inverse)):
        for g, w in zip(got, want):
            assert np.abs(_f32(g) - w.numpy()).max() <= \
                FFT_TOL["float32"] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fft_tol_flags_a_four_step_without_its_twiddle(dtype):
    """The inter-pass factor dropped reads far above `FFT_TOL` in every
    dtype: the check on the card would see it."""
    rng = np.random.default_rng(3)
    td = getattr(torch, dtype)
    re, im = (torch.as_tensor(rng.normal(size=(2, 1 << 14))
                              .astype(np.float32)).to(td) for _ in range(2))
    want = fft_plain(re, im)
    wrong = four_step_model(re, im, twiddle=False)
    scale = max(float(w.float().abs().max()) for w in want)
    diff = max(float((a.to(td).float() - b.float()).abs().max())
               for a, b in zip(wrong, want))
    assert diff > 10 * FFT_TOL[dtype] * scale
