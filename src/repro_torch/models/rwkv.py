"""RWKV-6 (Finch) block: attention-free, with a data-dependent
per-channel decay (the port's counterpart of the JAX package's
`models/rwkv.py`).

The structure is the reference's: a data-dependent token shift (LoRA),
five mixed streams (r, k, v, g, w), the per-channel decay
w_t = exp(-exp(w0 + lora(x))), the bonus u for the current token, a
head-wise group norm and the silu(g) gate.

WKV evaluators:
  * ``wkv6_scan``: the per-token oracle;
  * ``wkv6_chunked``: chunk-parallel and stable for any decay (the
    intra-chunk decay matrix built in log space with pairwise exponents
    <= 0), the state carried from chunk to chunk (``impl="stable"``,
    the configs' choice);
  * ``wkv6_chunked_mm``: one product per chunk from two damped
    operands, the per-step log-decay clamped at ``wkv_clamp``
    (``impl="matmul"``);
  * ``wkv6_step``: one decode token.
Where the reference scans the chunks with ``lax.scan``, the port loops
over them. The state is (S: (B, H, K, V) float32, x_prev_att,
x_prev_ffn).

Over a mesh the evaluators, the token shift and the five mixed streams
run on each rank's shards (`sharding.local.local_call`): rows and heads
are independent in a scan, so a rank's batch rows and heads are exact
on their own, and the chunk loop dispatches no ``DTensor`` operation.
On plain tensors they are the one-device code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import P, apply_norm, fanin_std
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.local import local_call

__all__ = ["NUM_MIX", "rwkv_block_schema", "wkv6_scan", "wkv6_chunked",
           "wkv6_chunked_mm", "wkv6_step", "rwkv_time_mix",
           "rwkv_channel_mix", "rwkv_block", "rwkv_state_schema"]

NUM_MIX = 5  # r, k, v, g, w


def rwkv_block_schema(cfg):
    d = cfg.d_model
    K = cfg.ssm.head_size
    H = d // K  # wkv heads are tied to d_model / head_size
    r = cfg.ssm.lora_rank
    ff = cfg.d_ff
    return {
        "ln1": {"scale": P((d,), ("embed",), "ones"),
                "bias": P((d,), ("embed",), 0.0)},
        "ln2": {"scale": P((d,), ("embed",), "ones"),
                "bias": P((d,), ("embed",), 0.0)},
        "att": {
            "mu_x": P((d,), ("embed",), 0.0),
            "mu": P((NUM_MIX, d), (None, "embed"), 0.0),
            "lora_A": P((NUM_MIX, d, 32), (None, "embed", None),
                        fanin_std(d)),
            "lora_B": P((NUM_MIX, 32, d), (None, None, "embed"), 0.0),
            "w0": P((d,), ("embed",), ("uniform", -8.0, -6.0)),
            "wA": P((d, r), ("embed", None), fanin_std(d)),
            "wB": P((r, d), (None, "embed"), 0.0),
            "u": P((H, K), ("heads", "head_dim"), 0.02),
            "wr": P((d, d), ("embed", "mlp"), fanin_std(d)),
            "wk": P((d, d), ("embed", "mlp"), fanin_std(d)),
            "wv": P((d, d), ("embed", "mlp"), fanin_std(d)),
            "wg": P((d, d), ("embed", "mlp"), fanin_std(d)),
            "wo": P((d, d), ("mlp", "embed"), fanin_std(d)),
            "gn_scale": P((H, K), ("heads", "head_dim"), "ones"),
            "gn_bias": P((H, K), ("heads", "head_dim"), 0.0),
        },
        "ffn": {
            "mu_r": P((d,), ("embed",), 0.0),
            "mu_k": P((d,), ("embed",), 0.0),
            "wr": P((d, d), ("embed", "mlp"), fanin_std(d)),
            "wk": P((d, ff), ("embed", "mlp"), fanin_std(d)),
            "wv": P((ff, d), ("mlp", "embed"), fanin_std(ff)),
        },
    }


# ---------------------------------------------------------------------------
# WKV6 evaluators
# ---------------------------------------------------------------------------

def wkv6_scan(r, k, v, lw, u, s0):
    """Oracle. r, k, lw: (B, S, H, K); v: (B, S, H, V); u: (H, K);
    s0: (B, H, K, V). Returns (o (B, S, H, V), final state)."""
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    u = u.float()
    S = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = torch.exp(lw[:, t])[..., None] * S + kv
    return torch.stack(outs, 1), S


def _chunks(chunk: int, r, k, v, lw):
    """(L, the chunk count, r, k, v, lw as float32 (B, n, L, H, *)): axis
    1 cut into chunks of L = min(chunk, S), the last one padded with
    k = v = 0 (no kv writes) and lw = 0 (decay 1), so the state is
    exact."""
    B, S, H, K = r.shape
    L = min(chunk, S)
    n = -S % L
    if n:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, n)) for t in (r, k, v, lw))
    nc = r.shape[1] // L
    return (L, nc) + tuple(t.reshape(B, nc, L, H, t.shape[-1]).float()
                           for t in (r, k, v, lw))


# the role dims (batch, heads) of the evaluators' operands r, k, v, lw,
# u, s0 and of their results o, S
_SCAN_DIMS = ((0, 2),) * 4 + ((None, 0), (0, 1))
_SCAN_OUT = ((0, 2), (0, 1))


def wkv6_chunked(r, k, v, lw, u, s0, chunk: int):
    """Chunk-parallel WKV6, numerically stable for any decay."""
    local = local_call(lambda *a: wkv6_chunked(*a, chunk),
                       (r, k, v, lw, u, s0), _SCAN_DIMS, _SCAN_OUT)
    if local is not None:
        return local
    B, S_in, H, _ = r.shape
    V = v.shape[-1]
    L, nc, rc, kc, vc, wc = _chunks(chunk, r, k, v, lw)
    u = u.float()
    dev = r.device
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev), -1)
    eye = torch.eye(L, dtype=torch.float32, device=dev)
    Sst = s0.float()
    outs = []
    for c in range(nc):
        rb, kb, vb, wb = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        ce = torch.cumsum(wb, dim=1)                       # inclusive
        # exclusive, summed as ce is (not ce - wb): ec_{j+1} is ce_j
        # itself, so the adjacent pair's exponent is exactly 0 however
        # large the decays (ce - wb rounds at ulp(ce))
        ec = torch.cumsum(F.pad(wb, (0, 0, 0, 0, 1, 0))[:, :L], dim=1)
        # intra-chunk: A[t,j] = sum_d r_t k_j exp(ec_t - ce_j), j < t
        expo = ec[:, :, None] - ce[:, None]                # (B,L,L,H,K) <= 0
        E = torch.exp(torch.where(mask[None, :, :, None, None], expo,
                                  -torch.inf))
        A = (rb[:, :, None] * kb[:, None] * E).sum(-1)     # (B,L,L,H)
        bonus = (rb * u * kb).sum(-1)                      # current token
        A = A + eye[None, :, :, None] * bonus[:, :, None, :]
        o = torch.einsum("blmh,bmhv->blhv", A, vb)
        # inter-chunk: the carried state's contribution
        q = rb * torch.exp(ec)                             # damped, <= |r|
        o = o + torch.einsum("blhk,bhkv->blhv", q, Sst)
        tot = ce[:, -1]                                    # (B,H,K)
        kd = kb * torch.exp(tot[:, None] - ce)             # damped
        Sst = torch.exp(tot)[..., None] * Sst + torch.einsum(
            "blhk,blhv->bhkv", kd, vb)
        outs.append(o)
    o = torch.stack(outs, 1).reshape(B, nc * L, H, V)
    return o[:, :S_in], Sst


def wkv6_chunked_mm(r, k, v, lw, u, s0, chunk: int, lw_min: float = -2.0):
    """Chunk-parallel WKV6 with one product per chunk: the intra-chunk
    matrix factors into two operands damped around the mid-chunk
    cumulative decay m,

        A[t,j] = sum_d (r_t exp(ec_t - m))_d * (k_j exp(m - ce_j))_d,

    which stay inside float32's range because the per-step log-decay is
    clamped at ``lw_min`` (chunks up to 64)."""
    local = local_call(lambda *a: wkv6_chunked_mm(*a, chunk, lw_min),
                       (r, k, v, lw, u, s0), _SCAN_DIMS, _SCAN_OUT)
    if local is not None:
        return local
    B, S_in, H, _ = r.shape
    V = v.shape[-1]
    L, nc, rc, kc, vc, wc = _chunks(chunk, r, k, v,
                                    torch.clamp(lw, min=lw_min))
    u = u.float()
    dev = r.device
    mask = torch.tril(torch.ones((L, L), dtype=torch.float32, device=dev),
                      -1)
    eye = torch.eye(L, dtype=torch.float32, device=dev)
    Sst = s0.float()
    outs = []
    for c in range(nc):
        rb, kb, vb, wb = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        ce = torch.cumsum(wb, dim=1)
        ec = ce - wb
        m = ce[:, L // 2][:, None]                         # (B,1,H,K)
        qf = rb * torch.exp(ec - m)                        # bounded
        kf = kb * torch.exp(m - ce)                        # bounded
        A = torch.einsum("blhk,bmhk->blmh", qf, kf) * mask[None, :, :, None]
        bonus = (rb * u * kb).sum(-1)
        A = A + eye[None, :, :, None] * bonus[:, :, None, :]
        o = torch.einsum("blmh,bmhv->blhv", A, vb)
        o = o + torch.einsum("blhk,bhkv->blhv", rb * torch.exp(ec), Sst)
        tot = ce[:, -1]
        kd = kb * torch.exp(tot[:, None] - ce)
        Sst = torch.exp(tot)[..., None] * Sst + torch.einsum(
            "blhk,blhv->bhkv", kd, vb)
        outs.append(o)
    o = torch.stack(outs, 1).reshape(B, nc * L, H, V)
    return o[:, :S_in], Sst


def wkv6_step(r, k, v, lw, u, s0):
    """One decode token. r, k, lw: (B, H, K); v: (B, H, V);
    s0: (B, H, K, V)."""
    local = local_call(wkv6_step, (r, k, v, lw, u, s0),
                       ((0, 1),) * 4 + ((None, 0), (0, 1)),
                       ((0, 1), (0, 1)))
    if local is not None:
        return local
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    kv = k[..., None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r,
                     s0 + u.float()[None, :, :, None] * kv)
    return o, torch.exp(lw)[..., None] * s0 + kv


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _token_shift(x, x_prev):
    """x: (B, S, d); x_prev: (B, d), the carry from the previous segment
    or step."""
    local = local_call(_token_shift, (x, x_prev), ((0, 2), (0, 1)),
                       ((0, 2),))
    if local is not None:
        return local
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _ddlerp(att, x, xs):
    """Data-dependent token shift (Finch): each stream's mix of x and
    shift(x). Returns (B, S, 5, d)."""
    dt = x.dtype
    sx = xs - x
    base = x + sx * att["mu_x"].to(dt)
    lo = torch.einsum("bsd,ndr->bsnr", base, att["lora_A"].to(dt))
    lo = torch.einsum("bsnr,nrd->bsnd", torch.tanh(lo), att["lora_B"].to(dt))
    mix = att["mu"].to(dt)[None, None] + lo
    return x[:, :, None, :] + sx[:, :, None, :] * mix


_MIX_WEIGHTS = ("mu_x", "mu", "lora_A", "lora_B")


def _mixed_streams(att, x, xs):
    """`_ddlerp`'s five streams (r, k, v, g, w), each (B, S, d). Over a
    mesh they are mixed on this rank's rows with the mixing weights
    gathered (`local_call`): the five streams share one (B, S, 5, d)
    tensor whose stream axis ``DTensor`` would otherwise split."""
    w = tuple(att[k] for k in _MIX_WEIGHTS)
    local = local_call(
        lambda x, xs, *w: _ddlerp(dict(zip(_MIX_WEIGHTS, w)), x,
                                  xs).unbind(2),
        (x, xs) + w, ((0,),) * 2 + ((None,),) * 4, ((0,),) * NUM_MIX,
        gather=(2, 3, 4, 5))
    if local is not None:
        return local
    return _ddlerp(att, x, xs).unbind(2)


def rwkv_time_mix(att, x, x_prev, s0, cfg, *, mode: str):
    """Returns (out, the last position's x, the final WKV state)."""
    B, S, d = x.shape
    K = cfg.ssm.head_size
    H = d // K
    dt = x.dtype
    xs = _token_shift(x, x_prev)
    xr, xk, xv, xg, xw = _mixed_streams(att, x, xs)
    r = torch.matmul(xr, att["wr"].to(dt))
    k = torch.matmul(xk, att["wk"].to(dt))
    v = torch.matmul(xv, att["wv"].to(dt))
    g = torch.matmul(xg, att["wg"].to(dt))
    # data-dependent log-decay, float32 (exp(w0 + lora) is the decay rate)
    dw = torch.matmul(torch.tanh(torch.matmul(xw.float(),
                                              att["wA"].float())),
                      att["wB"].float())
    lw = -torch.exp(att["w0"].float() + dw)                # (B,S,d) <= 0

    def hs(t):
        return t.reshape(B, S, H, K)

    if mode == "decode":
        o, s_fin = wkv6_step(hs(r)[:, 0], hs(k)[:, 0], hs(v)[:, 0],
                             hs(lw)[:, 0], att["u"], s0)
        o = o[:, None]
    elif cfg.ssm.impl == "matmul":
        o, s_fin = wkv6_chunked_mm(hs(r), hs(k), hs(v), hs(lw), att["u"],
                                   s0, cfg.ssm.chunk_size, cfg.ssm.wkv_clamp)
    else:
        o, s_fin = wkv6_chunked(hs(r), hs(k), hs(v), hs(lw), att["u"], s0,
                                cfg.ssm.chunk_size)
    # head-wise group norm
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    o = (o - mu) * torch.rsqrt(var + 64e-5)
    o = o * att["gn_scale"].to(o.dtype) + att["gn_bias"].to(o.dtype)
    o = o.reshape(B, S, d).to(dt) * F.silu(g)
    return torch.matmul(o, att["wo"].to(dt)), x[:, -1, :], s_fin


def rwkv_channel_mix(ffn, x, x_prev):
    dt = x.dtype
    xs = _token_shift(x, x_prev)
    xr = x + (xs - x) * ffn["mu_r"].to(dt)
    xk = x + (xs - x) * ffn["mu_k"].to(dt)
    rg = torch.sigmoid(torch.matmul(xr, ffn["wr"].to(dt)))
    k = torch.square(F.relu(torch.matmul(xk, ffn["wk"].to(dt))))
    return rg * torch.matmul(k, ffn["wv"].to(dt)), x[:, -1, :]


def rwkv_block(params, x, state, cfg, *, mode: str):
    """state: dict(s, att_prev, ffn_prev). Returns (x_out, new state)."""
    h = apply_norm(params["ln1"], x, kind="layernorm", eps=cfg.norm_eps)
    att_out, att_prev, s_fin = rwkv_time_mix(
        params["att"], h, state["att_prev"], state["s"], cfg, mode=mode)
    # over a mesh the residual is summed over the model axis here, as
    # after each sublayer (`transformer._repeat`): on a partial sum
    # DTensor would run the channel mix's products with their weights
    # gathered, on every model rank
    x = constrain(x + att_out, "btd")
    h = apply_norm(params["ln2"], x, kind="layernorm", eps=cfg.norm_eps)
    ffn_out, ffn_prev = rwkv_channel_mix(params["ffn"], h, state["ffn_prev"])
    return x + ffn_out, {"s": s_fin,
                         "att_prev": att_prev.to(state["att_prev"].dtype),
                         "ffn_prev": ffn_prev.to(state["ffn_prev"].dtype)}


def rwkv_state_schema(cfg, batch: int):
    d = cfg.d_model
    K = cfg.ssm.head_size
    H = d // K
    return {
        "s": P((batch, H, K, K), ("batch", "heads", None, None), 0.0,
               torch.float32),
        "att_prev": P((batch, d), ("batch", "embed"), 0.0, torch.float32),
        "ffn_prev": P((batch, d), ("batch", "embed"), 0.0, torch.float32),
    }
