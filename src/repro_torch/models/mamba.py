"""Mamba2 (SSD) block: a scalar data-dependent decay per head and a short
causal convolution (the port's counterpart of the JAX package's
`models/mamba.py`).

Evaluators:
  * ``ssd_scan``: the per-token oracle;
  * ``ssd_chunked``: chunk-parallel SSD (a segment-sum decay matrix per
    head, the (H, P, N) state carried from chunk to chunk; the reference
    scans the chunks with ``lax.scan``, the port loops over them).
The depthwise causal conv1d (k = 4) runs over the (x, B, C) channels in
plain PyTorch, as the reference's model path runs it in plain jnp.

Over a mesh both run on each rank's shards (`sharding.local.local_call`):
batch rows and heads (channels, for the convolution) are independent,
so the chunk loop dispatches no ``DTensor`` operation. So do the block's
two projections (`_project`): the input projection with its width split
over "model" (its cotangent too, so that its weight's gradient is each
rank's share), the output projection contracting over that split. On
plain tensors they are the one-device code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import P, apply_norm, fanin_std
from repro_torch.sharding.local import local_call

__all__ = ["mamba_block_schema", "causal_conv1d", "ssd_scan",
           "ssd_chunked", "mamba_block", "mamba_state_schema"]


def mamba_block_schema(cfg):
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    H = d_in // s.head_size
    N = s.d_state
    conv_ch = d_in + 2 * N
    return {
        "norm": {"scale": P((d,), ("embed",), "ones")},
        "in_proj": P((d, 2 * d_in + 2 * N + H), ("embed", "mlp"),
                     fanin_std(d)),
        "conv_w": P((s.conv_kernel, conv_ch), ("conv", "mlp"),
                    fanin_std(s.conv_kernel)),
        "conv_b": P((conv_ch,), ("mlp",), 0.0),
        "A_log": P((H,), ("heads",), ("uniform", 0.0, 1.25)),
        "D": P((H,), ("heads",), "ones"),
        "dt_bias": P((H,), ("heads",), ("uniform", -4.6, -2.3)),
        "gn_scale": P((d_in,), ("mlp",), "ones"),
        "out_proj": P((d_in, d), ("mlp", "embed"), fanin_std(d_in)),
    }


def causal_conv1d(x, w, b, *, state=None):
    """x: (B, S, C); w: (k, C); depthwise causal conv.

    state: (B, k-1, C), the trailing inputs of the previous call (decode),
    or None (train/prefill: zeros on the left). Returns (y, new state)."""
    # roles (batch, channels) of x, w, b, state and of y, the new state
    if state is None:
        local = local_call(causal_conv1d, (x, w, b),
                           ((0, 2), (None, 1), (None, 0)),
                           ((0, 2), (0, 2)))
    else:
        local = local_call(lambda x, w, b, st: causal_conv1d(x, w, b,
                                                             state=st),
                           (x, w, b, state),
                           ((0, 2), (None, 1), (None, 0), (0, 2)),
                           ((0, 2), (0, 2)))
    if local is not None:
        return local
    B, S, C = x.shape
    k = w.shape[0]
    state_dtype = x.dtype if state is None else state.dtype
    if state is None:
        state = x.new_zeros((B, k - 1, C))
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+k-1, C)
    y = x.new_zeros((B, S, C))
    for i in range(k):  # k is tiny (4): the taps unrolled
        y = y + xp[:, i:i + S, :] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, xp[:, S:, :].to(state_dtype)


def ssd_scan(xh, dt, A, B_, C_, s0):
    """Oracle. xh: (B, S, H, P); dt: (B, S, H); B_, C_: (B, S, N);
    s0: (B, H, P, N)."""
    xh, dt, B_, C_ = (t.float() for t in (xh, dt, B_, C_))
    S = s0.float()
    ys = []
    for t in range(xh.shape[1]):
        a = torch.exp(dt[:, t] * A[None])                  # (B,H) in (0,1)
        S = a[..., None, None] * S + torch.einsum(
            "bhp,bn->bhpn", xh[:, t] * dt[:, t, :, None], B_[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", S, C_[:, t]))
    return torch.stack(ys, 1), S


def ssd_chunked(xh, dt, A, B_, C_, s0, chunk: int):
    """Chunk-parallel SSD: a scalar decay per head gives an (L, L)
    segment-sum matrix per chunk."""
    # roles (batch, heads): B_ and C_ are every head's
    local = local_call(lambda *a: ssd_chunked(*a, chunk),
                       (xh, dt, A, B_, C_, s0),
                       ((0, 2), (0, 2), (None, 0), (0, None), (0, None),
                        (0, 1)), ((0, 2), (0, 1)))
    if local is not None:
        return local
    B, S_in, H, Pd = xh.shape
    N = B_.shape[-1]
    L = min(chunk, S_in)
    n = -S_in % L
    if n:  # pad: x = 0 (no writes), dt = 0 (decay 1), so the state is exact
        xh = F.pad(xh, (0, 0, 0, 0, 0, n))
        dt, B_, C_ = (F.pad(t, (0, 0, 0, n)) for t in (dt, B_, C_))
    nc = xh.shape[1] // L
    xc = (xh.float() * dt.float()[..., None]).reshape(B, nc, L, H, Pd)
    ac = (dt.float() * A.float()[None, None]).reshape(B, nc, L, H)
    bc = B_.reshape(B, nc, L, N).float()
    cc = C_.reshape(B, nc, L, N).float()
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xh.device))      # inclusive
    Sst = s0.float()
    ys = []
    for c in range(nc):
        xb, ab, bb, cb = xc[:, c], ac[:, c], bc[:, c], cc[:, c]
        ca = torch.cumsum(ab, dim=1)                       # (B,L,H)
        # decay matrix D[t,j] = exp(ca_t - ca_j), j <= t (y_t reads S_t)
        expo = ca[:, :, None] - ca[:, None]                # (B,L,L,H)
        Dm = torch.where(mask[None, :, :, None], torch.exp(expo), 0.0)
        cb_bt = torch.einsum("bln,bmn->blm", cb, bb)       # (B,L,L)
        y = torch.einsum("blmh,bmhp->blhp", cb_bt[..., None] * Dm, xb)
        # inter-chunk
        y = y + torch.einsum("bln,bhpn->blhp", cb, Sst) \
            * torch.exp(ca)[..., None]
        # state update
        tot = ca[:, -1]                                    # (B,H)
        kd = torch.exp(tot[:, None] - ca)                  # (B,L,H)
        Sst = torch.exp(tot)[..., None, None] * Sst + torch.einsum(
            "blhp,bln->bhpn", xb * kd[..., None], bb)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, nc * L, H, Pd)
    return y[:, :S_in], Sst


def _project(x, w, dims, out_dims):
    """``x @ w`` on each rank's shards (`local_call`: roles (rows, width),
    ``w`` gathered where ZeRO-3 splits its other dim), so that neither
    the product nor its gradients depend on the layout ``DTensor`` would
    choose. On a three-axis mesh ``DTensor`` took the input projection's
    cotangent whole over "model" (the split's gather hands it back so)
    and ran the weight's gradient over the whole width on every model
    rank. ``x @ w`` itself on a plain tensor or a layout that is not
    local."""
    local = local_call(torch.matmul, (x, w), dims, (out_dims,), gather=(1,))
    return torch.matmul(x, w) if local is None else local


def mamba_block(params, x, state, cfg, *, mode: str):
    """x: (B, S, d); state: dict(conv: (B, k-1, C), s: (B, H, P, N)).
    Returns (x + out, new state)."""
    s = cfg.ssm
    B, S, d = x.shape
    d_in = s.expand * d
    H = d_in // s.head_size
    Pd, N = s.head_size, s.d_state
    cd = x.dtype

    h = apply_norm(params["norm"], x, kind="rmsnorm", eps=cfg.norm_eps)
    # roles (rows, width): the width split over "model" in the output
    zxbcdt = _project(h, params["in_proj"].to(cd), ((0, None), (None, 1)),
                      (0, 2))
    z, xr, B_, C_, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)

    conv_out, conv_state = causal_conv1d(
        torch.cat([xr, B_, C_], dim=-1), params["conv_w"], params["conv_b"],
        state=state["conv"])
    xr, B_, C_ = torch.split(F.silu(conv_out), [d_in, N, N], dim=-1)

    # softplus as jax.nn.softplus: logaddexp(x, 0)
    dtf = dt.float() + params["dt_bias"].float()
    dt = torch.logaddexp(dtf, torch.zeros_like(dtf))       # (B,S,H)
    A = -torch.exp(params["A_log"].float())                # (H,)
    xh = xr.reshape(B, S, H, Pd)

    if mode == "decode":
        a = torch.exp(dt[:, 0] * A[None])
        s_fin = a[..., None, None] * state["s"] + torch.einsum(
            "bhp,bn->bhpn", xh[:, 0].float() * dt[:, 0, :, None],
            B_[:, 0].float())
        y = torch.einsum("bhpn,bn->bhp", s_fin, C_[:, 0].float())[:, None]
    else:
        y, s_fin = ssd_chunked(xh, dt, A, B_, C_, state["s"], s.chunk_size)

    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in)
    # the gated RMS norm of mamba2: norm(y * silu(z))
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["gn_scale"].float()
    # roles (rows, width): a sum over the split width, partial over "model"
    out = _project(y.to(cd), params["out_proj"].to(cd), ((0, 2), (None, 0)),
                   (0, None))
    return x + out, {"conv": conv_state, "s": s_fin}


def mamba_state_schema(cfg, batch: int):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_size
    conv_ch = d_in + 2 * s.d_state
    return {
        "conv": P((batch, s.conv_kernel - 1, conv_ch),
                  ("batch", None, "mlp"), 0.0, torch.float32),
        "s": P((batch, H, s.head_size, s.d_state),
               ("batch", "heads", None, None), 0.0, torch.float32),
    }
