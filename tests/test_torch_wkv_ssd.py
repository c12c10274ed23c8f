"""The port's RWKV-6 WKV and Mamba2 SSD evaluators (`repro_torch.models.
rwkv`, `repro_torch.models.mamba`) against the JAX package's, on the CPU:
every case of `tests/test_wkv_ssd.py`, each run through both packages on
the same numpy inputs, plus the port's chunked forms against its own
oracles.

Everything is float32. The scans, the decode step and the convolution,
port against reference: atol = rtol = 1e-5 (the same formulas, summed in
another order). The chunked forms sum r k exp(.) products that cancel:
at chunk 64 the reference's and the port's both sit up to 6e-6 x max|o|
from a float64 scan (outputs up to ~22), so a chunked output is held to
atol = 2e-5 x max|want| (rtol 1e-5), against the reference and against
the port's own scan; under decay up to 30x the reference test's 1e-3.
The decode continuation: 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import mamba as j_mamba
from repro.models import rwkv as j_rwkv
from repro_torch.models import mamba, rwkv

PARITY = dict(atol=1e-5, rtol=1e-5)
CHUNKED = "chunked"        # atol 2e-5 x max|want|, rtol 1e-5 (see above)


def _wkv_inputs(rng, B=2, S=32, H=2, K=8, V=8, decay_scale=1.0):
    r = rng.normal(size=(B, S, H, K)).astype(np.float32)
    k = rng.normal(size=(B, S, H, K)).astype(np.float32)
    v = rng.normal(size=(B, S, H, V)).astype(np.float32)
    lw = (-np.exp(rng.normal(size=(B, S, H, K)).astype(np.float32))
          * np.float32(decay_scale)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, K, V)).astype(np.float32)
          * np.float32(0.1)).astype(np.float32)
    return r, k, v, lw, u, s0


def _both(fn_j, fn_t, args, *extra):
    want = fn_j(*(jnp.asarray(a) for a in args), *extra)
    got = fn_t(*(torch.from_numpy(a) for a in args), *extra)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _close(got, want, tol):
    for g, w in zip(got, want):
        if tol == CHUNKED:
            np.testing.assert_allclose(
                g, w, atol=2e-5 * float(np.abs(w).max()), rtol=1e-5)
        else:
            np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_wkv6_chunked_matches_scan(chunk, rng):
    args = _wkv_inputs(rng)
    want_scan, got_scan = _both(j_rwkv.wkv6_scan, rwkv.wkv6_scan, args)
    _close(got_scan, want_scan, PARITY)
    want, got = _both(j_rwkv.wkv6_chunked, rwkv.wkv6_chunked, args, chunk)
    _close(got, want, CHUNKED)
    _close(got, got_scan, CHUNKED)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.1, 30.0))
def test_wkv6_chunked_stable_any_decay(seed, decay_scale):
    """The log-space pairwise form stays finite for any decay strength
    and agrees with the reference's and with the port's scan."""
    rng = np.random.default_rng(seed)
    args = _wkv_inputs(rng, decay_scale=decay_scale)
    want, got = _both(j_rwkv.wkv6_chunked, rwkv.wkv6_chunked, args, 8)
    assert all(np.isfinite(g).all() for g in got)
    _close(got, want, CHUNKED)
    scan = rwkv.wkv6_scan(*(torch.from_numpy(a) for a in args))
    _close(got, [s.numpy() for s in scan], dict(atol=1e-3, rtol=1e-3))


def _wkv6_scan_f64(r, k, v, lw, u, s0):
    """The per-token recurrence in float64 numpy: the exact output."""
    r, k, v, lw, u, s = (np.asarray(a, np.float64)
                         for a in (r, k, v, lw, u, s0))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(np.einsum("bhk,bhkv->bhv", r[:, t],
                              s + u[None, :, :, None] * kv))
        s = np.exp(lw[:, t])[..., None] * s + kv
    return np.stack(outs, 1)


def test_wkv6_chunked_adjacent_pair_exact_under_large_decay():
    """Decays scaled 30x put the chunk's cumulative log-decay near -400,
    where ce - w rounds at ~3e-5: the pair (j + 1, j), whose exponent is
    exactly 0, then reads e^(+-3e-5). The exclusive cumsum summed
    directly keeps it 0: on this example the port sits 8e-6 from the
    float64 scan (max |o| ~20) where ce - w put it at 4.6e-4 and the
    reference sits at 1.6e-4; held to 2e-6 x max |o|."""
    args = _wkv_inputs(np.random.default_rng(1), decay_scale=30.0)
    want = _wkv6_scan_f64(*args)
    got, _ = rwkv.wkv6_chunked(*(torch.from_numpy(a) for a in args), 8)
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= 2e-6 * np.abs(want).max(), err


def test_wkv6_decode_continues_scan(rng):
    r, k, v, lw, u, s0 = (torch.from_numpy(a)
                          for a in _wkv_inputs(rng, S=9))
    o_all, s_all = rwkv.wkv6_scan(r, k, v, lw, u, s0)
    o8, s8 = rwkv.wkv6_scan(r[:, :8], k[:, :8], v[:, :8], lw[:, :8], u, s0)
    o9, s9 = rwkv.wkv6_step(r[:, 8], k[:, 8], v[:, 8], lw[:, 8], u, s8)
    torch.testing.assert_close(o9, o_all[:, 8], atol=1e-5, rtol=0)
    torch.testing.assert_close(s9, s_all, atol=1e-5, rtol=0)
    want = j_rwkv.wkv6_step(*(jnp.asarray(t.numpy()) for t in (
        r[:, 8], k[:, 8], v[:, 8], lw[:, 8], u, s8)))
    _close([o9.numpy(), s9.numpy()], [np.asarray(w) for w in want], PARITY)


@pytest.mark.parametrize("S,chunk", [(30, 8), (5, 16), (64, 64)])
def test_wkv6_chunked_pads_the_last_chunk(S, chunk, rng):
    """A length that chunks do not divide pads the last one (k = v = 0,
    decay 1): output and state equal the reference's and the scan's."""
    args = _wkv_inputs(rng, S=S)
    want, got = _both(j_rwkv.wkv6_chunked, rwkv.wkv6_chunked, args, chunk)
    _close(got, want, CHUNKED)
    scan = rwkv.wkv6_scan(*(torch.from_numpy(a) for a in args))
    _close(got, [s.numpy() for s in scan], CHUNKED)


@pytest.mark.parametrize("S,chunk", [(32, 8), (30, 16)])
def test_wkv6_chunked_mm_matches_the_reference(S, chunk, rng):
    """The one-product form (``impl="matmul"``) with its decay clamp at
    -2: the reference's output; the scan's where no decay is clamped."""
    args = _wkv_inputs(rng, S=S)
    want, got = _both(j_rwkv.wkv6_chunked_mm, rwkv.wkv6_chunked_mm, args,
                      chunk, -2.0)
    _close(got, want, CHUNKED)
    r, k, v, lw, u, s0 = args
    lw = np.maximum(lw, -2.0)
    scan = rwkv.wkv6_scan(*(torch.from_numpy(a) for a in (r, k, v, lw, u,
                                                           s0)))
    _close(got, [s.numpy() for s in scan], CHUNKED)


def _ssd_inputs(rng, B=2, S=32, H=3, P=8, N=4):
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    B_ = rng.normal(size=(B, S, N)).astype(np.float32)
    C_ = rng.normal(size=(B, S, N)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, P, N)).astype(np.float32)
          * np.float32(0.1)).astype(np.float32)
    return xh, dt, A, B_, C_, s0


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_scan(chunk, rng):
    args = _ssd_inputs(rng)
    want_scan, got_scan = _both(j_mamba.ssd_scan, mamba.ssd_scan, args)
    _close(got_scan, want_scan, PARITY)
    want, got = _both(j_mamba.ssd_chunked, mamba.ssd_chunked, args, chunk)
    _close(got, want, CHUNKED)
    _close(got, got_scan, CHUNKED)


@pytest.mark.parametrize("S,chunk", [(30, 8), (3, 16)])
def test_ssd_chunked_pads_the_last_chunk(S, chunk, rng):
    args = _ssd_inputs(rng, S=S)
    want, got = _both(j_mamba.ssd_chunked, mamba.ssd_chunked, args, chunk)
    _close(got, want, CHUNKED)
    scan = mamba.ssd_scan(*(torch.from_numpy(a) for a in args))
    _close(got, [s.numpy() for s in scan], CHUNKED)


def test_causal_conv1d_matches_numpy(rng):
    x = rng.normal(size=(2, 16, 3)).astype(np.float32)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = np.zeros((3,), np.float32)
    y, state = mamba.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b))
    for c in range(3):
        # y[t] = sum_i w[i] x[t-(k-1)+i]  (w[k-1] multiplies the current x)
        ref = np.convolve(x[0, :, c], w[::-1, c])[:16]
        np.testing.assert_allclose(y[0, :, c].numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(state.numpy(), x[:, -3:, :])
    wy, ws = j_mamba.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **PARITY)
    np.testing.assert_array_equal(state.numpy(), np.asarray(ws))


def test_causal_conv1d_streaming_equivalence(rng):
    """Block by block with the state equals one shot (the prefill to
    decode handoff), and each block equals the reference's."""
    x = rng.normal(size=(1, 24, 2)).astype(np.float32)
    w = rng.normal(size=(4, 2)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    y_full, _ = mamba.causal_conv1d(torch.from_numpy(x), tw, tb)
    state, jstate, outs = None, None, []
    for i in range(0, 24, 8):
        y, state = mamba.causal_conv1d(torch.from_numpy(x[:, i:i + 8]), tw,
                                       tb, state=state)
        jy, jstate = j_mamba.causal_conv1d(jnp.asarray(x[:, i:i + 8]),
                                           jnp.asarray(w), jnp.asarray(b),
                                           state=jstate)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **PARITY)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(),
                               atol=1e-6)
