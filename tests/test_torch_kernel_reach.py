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
8192) through in numpy with the kernel's own tile, cluster, block and
address arithmetic and its host table, against `fft_plain`, so that a
fault in that arithmetic shows without a card; the same arithmetic shows
that every point is read and written once and that every strided global
access moves runs of at least 32 bytes, from 2^14 to 2^26 points.
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
from repro_torch.kernels.fft.kernel import (FFT_TOL, FOUR_STEP_BLOCK_POINTS,
                                            FOUR_STEP_LINES, MAX_CLUSTER,
                                            MAX_N, MAX_THREADS, ROW_MAX_N,
                                            four_step_model, four_step_plan,
                                            four_step_split, four_step_table,
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


@pytest.mark.parametrize("n,plan", [
    (16384, ((128, 1, 128, 128), (128, 1, 128, 128))),
    (32768, ((256, 1, 256, 256), (128, 1, 128, 128))),
    (1 << 17, ((512, 2, 256, 256), (256, 1, 256, 256))),
    (1 << 20, ((1024, 4, 256, 256), (1024, 4, 256, 256))),
    (1 << 21, ((2048, 8, 256, 256), (1024, 4, 256, 256))),
    (1 << 24, ((4096, 8, 512, 512), (4096, 8, 512, 512))),
    (1 << 26, ((8192, 8, 1024, 512), (8192, 8, 1024, 512)))])
def test_four_step_plan(n, plan):
    """(line, cluster, sub-line, threads) of each pass: lines of N1 then
    N2 points, a tile of 16 lines over clusters of blocks of at least
    4096 points, at most 8 blocks."""
    got = four_step_plan(n)
    assert tuple(tuple(p) for p in got) == plan
    p1, p2 = got
    assert p1.line * p2.line == n and p2.line <= p1.line <= ROW_MAX_N
    for p in got:
        assert p.cluster * p.sub == p.line and p.cluster <= MAX_CLUSTER
        assert FOUR_STEP_LINES * p.sub >= min(FOUR_STEP_BLOCK_POINTS,
                                              FOUR_STEP_LINES * p.line)


def test_one_2p20_row_fills_the_card():
    """One row of 2^20 points: each pass launches 256 blocks, two for
    each of the H100's 132 SMs (blocks of 8192 points made 128)."""
    for p in four_step_plan(1 << 20):
        blocks = (1 << 20) // (FOUR_STEP_LINES * p.sub)
        assert blocks == 256 and blocks >= 132


def test_four_step_bounds_match_the_source():
    assert ROW_MAX_N == 1 << _cu_const("kMaxLog")
    assert MAX_N == 1 << _cu_const("kMaxFourStepLog")
    assert FOUR_STEP_LINES == _cu_const("kFourStepLines")
    assert FOUR_STEP_BLOCK_POINTS == _cu_const("kFourStepBlockPoints")
    assert MAX_CLUSTER == _cu_const("kMaxCluster")
    assert MAX_THREADS == _cu_const("kMaxThreads")


@pytest.mark.parametrize("n", [1 << 14, 1 << 20, 1 << 26])
def test_four_step_twiddles_are_float64_cast_once(n):
    n1, n2 = (p.line for p in four_step_plan(n))
    fine, coarse = four_step_twiddles(n)
    j = np.arange(n1)
    np.testing.assert_array_equal(fine[:, 0], np.cos(-2 * np.pi * j / n)
                                  .astype(np.float32))
    np.testing.assert_array_equal(fine[:, 1], np.sin(-2 * np.pi * j / n)
                                  .astype(np.float32))
    j = np.arange(n2)
    np.testing.assert_array_equal(coarse[:, 0], np.cos(-2 * np.pi * j * n1 /
                                                       n).astype(np.float32))
    for line in (n1, n2):
        j = np.arange(line)
        np.testing.assert_array_equal(
            four_step_split(line), np.stack(
                [np.cos(-2 * np.pi * j / line), np.sin(-2 * np.pi * j / line)],
                axis=-1).astype(np.float32))
    # the product W_N^e = coarse[e // N1] fine[e % N1] over a sample of e,
    # against float64: two roundings of 2^-24 each, and the product's
    e = np.random.default_rng(0).integers(0, n, 4096)
    w = (coarse[e // n1] @ [1, 1j]) * (fine[e % n1] @ [1, 1j])
    assert np.abs(w - np.exp(-2j * np.pi * e / n)).max() < 4e-7


# The kernel's address arithmetic (fft.cu, four_step_kernel), in numpy.
# A pass is 2^(lg_k + lg_o - 4) blocks a row, block b the rank h = b mod
# K of the cluster of tile b >> lg_k; the tile is the 16 lines c0 .. c0 +
# 15 of row r. Thread t's access v is q = t + threads v.

def _lg(x: int) -> int:
    return x.bit_length() - 1


def _geometry(n: int, second: bool) -> tuple:
    """(pass plan, lg L, lg K, lg M, lg of the other factor)."""
    p = four_step_plan(n)[int(second)]
    lg = _lg(n)
    lg_o = (lg + 1) // 2 if second else lg // 2
    return p, _lg(p.line), _lg(p.cluster), _lg(p.sub), lg_o


def _blocks(R: int, n: int, second: bool, blocks=None) -> tuple:
    """(block, h, c0, base) of every block of the pass (or of ``blocks``),
    each (B, 1, 1)."""
    p, lg_l, lg_k, _, lg_o = _geometry(n, second)
    lg_tiles = lg_o - _lg(FOUR_STEP_LINES)
    b = np.arange(R << (lg_k + lg_tiles)) if blocks is None else \
        np.asarray(blocks)
    tile = b >> lg_k
    c0 = (tile & ((1 << lg_tiles) - 1)) << _lg(FOUR_STEP_LINES)
    base = (tile >> lg_tiles) << (lg_l + lg_o)
    return tuple(a.reshape(-1, 1, 1).astype(np.int64)
                 for a in (b, b & (p.cluster - 1), c0, base))


def _q(p, per_thread: int) -> np.ndarray:
    """q = t + threads v as (per_thread, threads)."""
    return np.arange(p.threads)[None, :] + \
        p.threads * np.arange(per_thread)[:, None]


def four_step_units(n: int, R: int, second: bool, blocks=None) -> tuple:
    """Each thread's units of the pass's load: (line c, point n), each
    (B, units, threads), and the unit's width VU. Block h owns the points
    n of h M / K .. (h + 1) M / K - 1 and loads n + m M (m < K) of the VU
    lines c .. c + VU - 1: pass 1 VU of C consecutive columns at a point,
    pass 2 a line at consecutive n across the warp."""
    p, lg_l, lg_k, lm, lg_o = _geometry(n, second)
    _, h, _, _ = _blocks(R, n, second, blocks)
    C, M, K = FOUR_STEP_LINES, p.sub, p.cluster
    nb = M // K
    vu = 2 if K >= 8 else 4
    q = _q(p, C * nb // vu // p.threads)[None]
    if not second:
        lv = _lg(C // vu)
        c, pt = (q & ((1 << lv) - 1)) * vu, q >> lv
    else:
        c, pt = (q >> _lg(nb)) * vu, q & (nb - 1)
    return c + 0 * h, h * nb + pt, vu


def four_step_element(n: int, R: int, second: bool, c, pt, m: int,
                      blocks=None):
    """The element index of line c's point pt + m M of the block's tile."""
    p, lg_l, _, _, lg_o = _geometry(n, second)
    _, _, c0, base = _blocks(R, n, second, blocks)
    point = pt + m * p.sub
    if not second:
        return base + (point << lg_o) + c0 + c
    return base + _scratch_index(c0 + c, point, lg_o)


def _scratch_index(k1, n2, lg_n1: int):
    """The scratch's (16-point, 16-line) tiles: (k1, n2) at ((n2 >> 4)
    N1 + k1) 16 + (n2 & 15)."""
    return (((n2 >> 4) << lg_n1) + k1) * 16 + (n2 & 15)


def four_step_in(n: int, R: int, second: bool, blocks=None) -> tuple:
    """Each access of the pass's load in the kernel's order (unit, share
    m, and in pass 2 line e of the unit): (first element g (B, steps,
    threads), elements an access): pass 1 a vector of VU columns, pass 2
    one float of a line."""
    c, pt, vu = four_step_units(n, R, second, blocks)
    K = four_step_plan(n)[int(second)].cluster
    steps = []
    for u in range(c.shape[1]):
        for m in range(K):
            for e in (range(vu) if second else (0,)):
                steps.append(four_step_element(
                    n, R, second, c[:, u:u + 1] + e, pt[:, u:u + 1], m,
                    blocks))
    return np.concatenate(steps, axis=1), (1 if second else vu)


def four_step_out(n: int, R: int, second: bool, elem: int,
                  blocks=None) -> tuple:
    """Each access of the pass's store: (first element g, line c, point
    k' of the block's share, k = K k' + h, elements VE): pass 1 to the
    float32 scratch's tiles (`_scratch_index`), pass 2 to the
    ``elem``-byte output at k1 + N1 k2; C consecutive lines a point,
    16-byte vectors."""
    p, lg_l, lg_k, lm, lg_o = _geometry(n, second)
    _, h, c0, base = _blocks(R, n, second, blocks)
    C, M = FOUR_STEP_LINES, p.sub
    ve = 16 // (elem if second else 4)
    lv = _lg(C // ve)
    q = _q(p, C * M // ve // p.threads)
    kp, c = q >> lv, (q & ((1 << lv) - 1)) * ve
    k = (kp << lg_k) + h
    if not second:
        return base + _scratch_index(k, c0 + c, lg_l), c, kp, k, ve
    return base + (k << lg_o) + c0 + c, c, kp, k, ve


def _tables(n: int) -> dict:
    """The host table at the kernel's offsets, as complex arrays."""
    p1, p2 = four_step_plan(n)
    table = four_step_table(n) @ np.array([1, 1j])
    o = len(stockham_table(p1.sub)) + len(stockham_table(p2.sub))
    out = {}
    for name, size in (("split1", p1.line), ("split2", p2.line),
                       ("fine", p1.line), ("coarse", p2.line)):
        out[name] = table[o: o + size]
        o += size
    assert o == len(table)
    return out


def four_step_walk(re: np.ndarray, im: np.ndarray, inverse: bool) -> tuple:
    """The kernel's two passes in numpy: each block's load by the
    kernel's addresses into its share of its tile's 16 lines, the
    cluster's radix-K step over its blocks' shares with the table's
    W_L^j, the M-point transforms by `fft_plain`, and the store by the
    kernel's addresses (pass 1 times the inter-pass factor coarse[e >>
    lg N1] fine[e & (N1 - 1)], e = n2 k1, at a vector's first column, and
    times fine[k1] for each next one); every point read and written
    once."""
    if inverse:
        re, im = im, re
    R, n = re.shape
    tab = _tables(n)
    src = (re + 1j * im).astype(np.complex64).ravel()

    def one_pass(data, second):
        p, lg_l, lg_k, lm, lg_o = _geometry(n, second)
        C, M, K = FOUR_STEP_LINES, p.sub, p.cluster
        c, pt, vu = four_step_units(n, R, second)
        nb = c.shape[0]
        seen = np.zeros(R * n, int)
        # each unit's VU lines x K shares, then the radix-K step over the
        # shares and W_L^(n j)
        x = np.zeros(c.shape + (vu, K), np.complex64)
        for e in range(vu):
            for m in range(K):
                g = four_step_element(n, R, second, c + e, pt, m)
                x[..., e, m] = data[g]
                np.add.at(seen, g.ravel(), 1)
        assert (seen == 1).all(), "a pass reads every point once"
        split = tab["split2" if second else "split1"]
        y = np.fft.fft(x, axis=-1) * split[pt[..., None, None] *
                                           np.arange(K)]
        # y_j[n] to block (tile, j) at (line c + e, n): every point once
        share = np.zeros((nb, C, M), np.complex64)
        hits = np.zeros((nb, C, M), int)
        bi = np.arange(nb)[:, None, None]
        for j in range(K):
            dest = np.broadcast_to((bi // K) * K + j, c.shape)
            for e in range(vu):
                share[dest, c + e, pt] = y[..., e, j]
                np.add.at(hits, (dest.ravel(), (c + e).ravel(),
                                 pt.ravel()), 1)
        assert (hits == 1).all(), "each sub-line point stored once"
        fr, fi = fft_plain(torch.as_tensor(share.real.reshape(-1, M).copy()),
                           torch.as_tensor(share.imag.reshape(-1, M).copy()))
        y = (fr.numpy() + 1j * fi.numpy()).astype(np.complex64) \
            .reshape(nb, C, M)
        g, c, kp, k, ve = four_step_out(n, R, second, 4)
        _, _, c0, _ = _blocks(R, n, second)
        out = np.zeros(R * n, np.complex64)
        hits = np.zeros(R * n, int)
        if not second:
            # W_N^(n2 k1) at the vector's first column, then times
            # fine[k1] = W_N^k1 a column
            ex = (c0 + c) * k
            assert ex.max() < n
            w = (tab["coarse"][ex >> lg_l] *
                 tab["fine"][ex & ((1 << lg_l) - 1)]).astype(np.complex64)
        for e in range(ve):
            v = y[bi, c + e, kp]
            if not second:
                if e:
                    w = (w * tab["fine"][k]).astype(np.complex64)
                v = v * w
            out[g + e] = v
            np.add.at(hits, (g + e).ravel(), 1)
        assert (hits == 1).all(), "a pass writes every point once"
        return out

    mid = one_pass(src, False)
    x = one_pass(mid, True).reshape(R, n)
    if inverse:
        x = x / n
        return x.imag.astype(np.float32), x.real.astype(np.float32)
    return x.real.astype(np.float32), x.imag.astype(np.float32)


@pytest.mark.parametrize("lg", range(14, 27))
def test_four_step_reads_and_writes_every_point_once(lg):
    """Over one row of N = 2^14 .. 2^26: each pass's loads read every
    point once and its stores write every point once, by the kernel's
    address arithmetic (a bitmap, blocks a chunk at a time)."""
    n = 1 << lg
    for second in (False, True):
        p = four_step_plan(n)[int(second)]
        nb = n // (FOUR_STEP_LINES * p.sub)
        for side in (four_step_in, four_step_out):
            hit = np.zeros(n, bool)
            count = 0
            for b0 in range(0, nb, 512):
                blocks = np.arange(b0, min(nb, b0 + 512))
                g, *_, ve = side(n, 1, second, blocks) \
                    if side is four_step_in else side(n, 1, second, 4, blocks)
                idx = (g[..., None] + np.arange(ve)).ravel()
                assert idx.min() >= 0 and idx.max() < n
                hit[idx] = True
                count += idx.size
            assert count == n and hit.all(), (lg, second, side.__name__)


def _runs(g: np.ndarray, ve: int, elem: int) -> np.ndarray:
    """Byte lengths of the contiguous runs each warp's access covers
    (lanes 32 t .. 32 t + 31 of one step v), over g (B, steps, threads)."""
    lo = (g * elem).reshape(g.shape[0], g.shape[1], -1, 32)
    lo = np.sort(lo, axis=-1)
    hi = lo + ve * elem
    lengths = []
    for row_lo, row_hi in zip(lo.reshape(-1, 32), hi.reshape(-1, 32)):
        start, end = row_lo[0], row_hi[0]
        for a, b in zip(row_lo[1:], row_hi[1:]):
            if a > end:
                lengths.append(end - start)
                start = a
            end = max(end, b)
        lengths.append(end - start)
    return np.array(lengths)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("lg", range(14, 27))
def test_four_step_strided_sides_move_32_contiguous_bytes(lg, elem):
    """Each warp's access on every side -- pass 1's load of the input and
    store of the scratch, pass 2's load of the scratch and store of the
    output -- covers runs of at least 32 contiguous bytes of a plane
    (float32 or a 16-bit type; the scratch is float32). Over the first,
    a middle and the last block of a pass, and two rows (the address
    arithmetic is affine in the block)."""
    n, R = 1 << lg, 2
    for second in (False, True):
        p = four_step_plan(n)[int(second)]
        nb = R * n // (FOUR_STEP_LINES * p.sub)
        blocks = sorted({0, 1, nb // 2 + 1, nb - 1})
        g, ve = four_step_in(n, R, second, blocks)
        runs = _runs(g, ve, 4 if second else elem)
        assert runs.min() >= 32, (second, runs.min())
        g, *_, ve = four_step_out(n, R, second, elem, blocks)
        runs = _runs(g, ve, elem if second else 4)
        assert runs.min() >= 32, (second, runs.min())


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
