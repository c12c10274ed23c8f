"""The port's standalone shuffle-unit, RoPE and flash-attention kernels
(`kernels/shuffle/csrc/shuffle.cu`, `kernels/rope/csrc/rope.cu`,
`kernels/flash_attention/csrc/flash_attention.cu`) against their plain
PyTorch versions. This file imports torch and the port only, so it also
runs on a machine with the card and no jax:

    python -m pytest -q -m cuda tests/test_torch_kernel_standalone.py

The `cuda`-marked tests skip without a card. Tolerances on the card:

* shuffle: bitwise (a permutation of 2- or 4-byte words);
* RoPE: max |diff| <= 1e-5 x max |plain| in float32 (the same float32
  operations in the same order, and the same expf/sinf/cosf of the CUDA
  math library that PyTorch's CUDA operators call), and one bfloat16
  rounding (2^-7 x max |plain|) in bfloat16;
* flash attention: |diff| <= 3e-5 + 3e-5 |plain| in float32, as
  `tests/test_flash_attention.py` holds the TPU kernel to the same oracle
  (sums run in another order, products as 3xTF32), and 1e-4 + 2^-7
  |plain| in bfloat16: both round the float32 result once, so they differ
  by at most one bfloat16 step (<= 2^-7 |plain|) plus the float32
  difference; `chip_smoke.py` holds the full-size runs to the same
  limits.

The CPU tests at the end check what the entries refuse before anything is
built, why the bfloat16 kernel splits P into two bfloat16 halves, why the
float32 kernel runs three TF32 products in place of each float32 one, and
walk the float32 kernel's shared-memory layouts and fragments through in
numpy."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import kernel as flash_kernel_module
from repro_torch.kernels.flash_attention.kernel import (
    FLASH_TOL, flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rope.kernel import LAYOUTS, rope_cuda, rope_plain
from repro_torch.kernels.rope.ops import rope
from repro_torch.kernels.shuffle.kernel import (OPS, shuffle_cuda,
                                                shuffle_plain)
from repro_torch.kernels.shuffle.ops import shuffle
from repro_torch.models.attention import NEG_INF


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _draw(shape, dtype, g, device) -> torch.Tensor:
    if dtype == torch.int32:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                             device=device, dtype=torch.int32)
    return torch.randn(shape, generator=g, device=device).to(dtype)


# ---------------------------------------------------------------- shuffle

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n", [2, 64, 128, 256])
@pytest.mark.parametrize("op", OPS)
def test_shuffle_kernel_matches_plain_on_card(card, op, n, dtype):
    g = torch.Generator(device=card).manual_seed(n)
    a, b = (_draw((37, n), dtype, g, card) for _ in range(2))
    halves = ("both",) if op.startswith("prune") else \
        ("both", "lower", "upper")
    amounts = (0, 32, -5, 2 * n + 3) if op == "circular_shift" else (32,)
    _cuda.reset_launches()
    for half in halves:
        for amount in amounts:
            got = shuffle_cuda(a, b, op, half=half, amount=amount)
            want = shuffle_plain(a, b, op, half=half, amount=amount)
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want)), (half, amount)
    assert _cuda.LAUNCHES["shuffle"][op] == len(halves) * len(amounts)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["interleave", "circular_shift",
                                "prune_odd"])
def test_shuffle_kernel_takes_any_width_its_op_takes(card, op):
    """Interleave and the shift take any N, the prunes any even N; rows
    that cross a block's 2048-word tile keep their place."""
    g = torch.Generator(device=card).manual_seed(7)
    for n in (6, 1000, 3000):
        a, b = (_draw((5, n), torch.float32, g, card) for _ in range(2))
        for half in ("both", "upper"):
            got = shuffle(a, b, op, half=half, amount=-1001)
            want = shuffle_plain(a, b, op, half=half, amount=-1001)
            assert torch.equal(_bits(got), _bits(want)), (n, half)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n,offset", [(256, 1), (128, 2), (6, 0),
                                      (7000, 0), (7000, 1)])
def test_shuffle_kernel_paths_on_card(card, n, offset, dtype):
    """The kernel's other paths: bases offset by one or two words and rows
    that 16-byte vectors do not tile (single-word copies, read in place),
    and rows too wide to stage (read in place)."""
    g = torch.Generator(device=card).manual_seed(n + offset)
    R = 37 if n <= 256 else 5
    a, b = (_draw((R * n + offset,), dtype, g, card)[offset:].view(R, n)
            for _ in range(2))
    for op in OPS:
        if op == "bit_reverse" and n & (n - 1):
            continue
        for half in ("both", "upper"):
            for amount in ((32, -5) if op == "circular_shift" else (32,)):
                got = shuffle_cuda(a, b, op, half=half, amount=amount)
                want = shuffle_plain(a, b, op, half=half, amount=amount)
                assert torch.equal(_bits(got), _bits(want)), (op, half)


# ------------------------------------------------------------------- RoPE

def _rope_close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-5 if want.dtype == torch.float32 else 2.0 ** -7
    diff = float((got.float() - want.float()).abs().max())
    assert diff <= tol * float(want.float().abs().max()), diff


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 120, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_kernel_matches_plain_on_card(card, layout, dh, dtype, theta):
    """Positions up to 8192, where the angle reaches thousands of radians."""
    g = torch.Generator(device=card).manual_seed(dh)
    x = torch.randn(300, dh, generator=g, device=card).to(dtype)
    pos = torch.randint(0, 8192, (300,), generator=g, device=card,
                        dtype=torch.int32)
    _cuda.reset_launches()
    got = rope_cuda(x, pos, theta=theta, layout=layout)
    assert _cuda.LAUNCHES["rope"][layout] == 1
    _rope_close(got, rope_plain(x, pos, theta=theta, layout=layout))


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64,
                                       torch.float32, torch.int16])
def test_rope_kernel_shares_positions_across_heads_on_card(card, pos_dtype):
    """Row r at positions[r // heads], read by the kernel in the
    positions' own dtype (int16 is converted to float32 first)."""
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(4 * 30, 120, generator=g, device=card)
    pos = torch.randint(0, 8192, (30,), generator=g,
                        device=card).to(pos_dtype)
    _cuda.reset_launches()
    got = rope_cuda(x, pos, theta=1e4, layout="neox", heads=4)
    assert _cuda.LAUNCHES["rope"]["neox"] == 1
    _rope_close(got, rope_plain(x, pos.repeat_interleave(4), theta=1e4,
                                layout="neox"))


@pytest.mark.cuda
def test_rope_entry_broadcasts_positions_on_card(card):
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(2, 50, 4, 64, generator=g, device=card)
    pos = torch.arange(50, device=card).expand(2, 50)
    got = rope(x, pos, theta=1e6, layout="neox")
    want = rope_plain(x.reshape(-1, 64),
                      pos[..., None].expand(2, 50, 4).reshape(-1),
                      theta=1e6, layout="neox").reshape(x.shape)
    _rope_close(got, want)


def _rope_draw(R: int, dh: int, dtype, offset: int, g, device):
    """(R, dh) of ``dtype`` whose base lies ``offset`` elements into its
    buffer (0, 1 element, or 8 bytes: the kernel's 16-byte, scalar and
    8-byte paths)."""
    buf = torch.randn(R * dh + offset, generator=g, device=device).to(dtype)
    return buf[offset:].view(R, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 3, 16, 32])
@pytest.mark.parametrize("dh", [2, 18, 24, 32, 64, 120, 128, 256])
def test_rope_kernel_walk_cases_on_card(card, dh, heads):
    """The shapes of `tests/test_torch_rope_layout.py`'s walk: both
    layouts and dtypes, bases offset by 0, 1 element and 8 bytes, 9 slots
    (a partial last block), positions up to 2^20 (sinf's slow range
    reduction)."""
    g = torch.Generator(device=card).manual_seed(dh * 64 + heads)
    _cuda.reset_launches()
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for offset in (0, 1, 8 // (4 if dtype == torch.float32 else 2)):
            x = _rope_draw(9 * heads, dh, dtype, offset, g, card)
            pos = torch.randint(0, 1 << 20, (9,), generator=g, device=card,
                                dtype=torch.int32)
            for layout in LAYOUTS:
                got = rope_cuda(x, pos, theta=1e4, layout=layout,
                                heads=heads)
                _rope_close(got, rope_plain(x, pos, theta=1e4,
                                            layout=layout, heads=heads))
                n += 1
    assert sum(_cuda.LAUNCHES["rope"].values()) == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_takes_a_row_offset_view_on_card(card, dtype):
    """``x[1:]`` is contiguous with a storage offset of one row; R2's rows
    of 120 elements."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(1 + 16 * 32, 120, generator=g, device=card).to(dtype)
    pos = torch.randint(0, 8192, (16,), generator=g, device=card)
    for layout in LAYOUTS:
        _rope_close(rope_cuda(x[1:], pos, theta=1e4, layout=layout,
                              heads=32),
                    rope_plain(x[1:], pos, theta=1e4, layout=layout,
                               heads=32))


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 5, 4097])
def test_rope_kernel_partial_last_block_on_card(card, slots):
    """Slot counts that no block's slots divide, at R1's row width."""
    g = torch.Generator(device=card).manual_seed(slots)
    x = torch.randn(slots * 16, 64, generator=g, device=card)
    pos = torch.randint(0, 1 << 20, (slots,), generator=g, device=card)
    for dtype in (torch.float32, torch.bfloat16):
        for layout in LAYOUTS:
            xd = x.to(dtype)
            _rope_close(rope_cuda(xd, pos, theta=1e6, layout=layout,
                                  heads=16),
                        rope_plain(xd, pos, theta=1e6, layout=layout,
                                   heads=16))


@pytest.mark.cuda
def test_rope_entry_broadcasts_batch_positions_on_card(card):
    """The entry on a (B, S, H, dh) array with (1, S) positions broadcast
    over the batch: one launch, the heads of a slot sharing a table."""
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(3, 40, 32, 120, generator=g, device=card) \
        .to(torch.bfloat16)
    pos = torch.randint(0, 1 << 20, (1, 40), generator=g, device=card)
    _cuda.reset_launches()
    got = rope(x, pos, theta=1e4, layout="neox")
    assert _cuda.LAUNCHES["rope"]["neox"] == 1
    want = rope_plain(x.reshape(-1, 120),
                      pos.expand(3, 40)[..., None].expand(3, 40, 32)
                      .reshape(-1), theta=1e4, layout="neox")
    _rope_close(got, want.reshape(x.shape))


# -------------------------------------------------------- flash attention

def _flash_close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    atol, rtol = FLASH_TOL[str(want.dtype).replace("torch.", "")]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window,amp", [
    ((2, 128, 128, 4, 2, 64), True, None, 1.0),     # GQA group 2
    ((1, 200, 200, 4, 1, 120), True, None, 1.0),    # MQA, S % 64 != 0, dh 120
    ((2, 256, 256, 4, 2, 32), True, 96, 1.0),       # sliding window
    ((1, 150, 150, 2, 2, 24), True, 32, 1.0),       # window inside one tile
    ((1, 96, 160, 4, 2, 64), False, None, 1.0),     # Sq < Skv, no mask
    ((1, 160, 96, 4, 4, 128), False, None, 1.0),    # Sq > Skv, no mask
    ((1, 100, 100, 2, 1, 256), False, 40, 1.0),     # window without causal
    ((1, 130, 130, 4, 2, 20), True, None, 1.0),     # dh 20: 40-byte rows
    ((1, 1, 777, 4, 2, 64), False, None, 1.0),      # one partial query tile
    ((1, 64, 4096, 4, 2, 64), True, 64, 1.0),       # most tiles off-band
    ((8, 65, 65, 32, 8, 64), True, None, 1.0),      # many heads, short S
    ((1, 150, 150, 4, 2, 200), True, None, 1.0),    # dh 200: N % 16 != 0
    ((1, 90, 90, 2, 1, 18), True, None, 1.0),       # dh 18: 4-byte copies
    ((1, 90, 90, 2, 1, 25), False, 30, 1.0),        # dh 25: 2-byte copies
    ((1, 140, 140, 2, 1, 144), True, None, 1.0),    # dh 144
    ((1, 70, 90, 2, 2, 184), False, None, 1.0),     # dh 184, Sq < Skv
    ((2, 192, 192, 4, 2, 64), True, None, 8 ** 0.5),  # scores to ~+-30
    ((1, 128, 32768, 4, 2, 64), False, None, 1.0),  # 32768 keys a row
])
def test_flash_kernel_matches_plain_on_card(card, shape, causal, window,
                                            amp, dtype):
    """q and k drawn with standard deviation ``amp``: scores of about
    +-4, or +-30 where amp is sqrt(8), where exp amplifies an error in a
    score the most."""
    B, Sq, Skv, H, KV, dh = shape
    g = torch.Generator(device=card).manual_seed(Sq + dh)
    q = (amp * torch.randn(B, Sq, H, dh, generator=g, device=card)).to(dtype)
    k = (amp * torch.randn(B, Skv, KV, dh, generator=g, device=card)) \
        .to(dtype)
    v = torch.randn(B, Skv, KV, dh, generator=g, device=card).to(dtype)
    _cuda.reset_launches()
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert _cuda.LAUNCHES["flash_attention"]["attention"] == 1
    _flash_close(got, flash_attention_plain(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs_on_card(card):
    """q, k and v as views of a fused (B, S, H + 2 KV, dh) projection and
    of a (B, H, S, dh) layout, and a bfloat16 q whose base lies 8 bytes
    past a 16-byte boundary: the kernel reads them through their strides
    (with 8-byte copies for the last)."""
    g = torch.Generator(device=card).manual_seed(11)
    qkv = torch.randn(2, 130, 8, 64, generator=g, device=card)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = flash_attention(q, k, v, causal=True, q_chunk=130, kv_chunk=130)
    _flash_close(got, flash_attention_plain(q.contiguous(), k.contiguous(),
                                            v.contiguous()))
    qt = torch.randn(2, 4, 130, 64, generator=g, device=card)
    got = flash_attention(qt.transpose(1, 2), k, v, causal=False,
                          q_chunk=65, kv_chunk=65)
    _flash_close(got, flash_attention_plain(
        qt.transpose(1, 2).contiguous(), k.contiguous(), v.contiguous(),
        causal=False))
    flat = torch.randn(4 + 2 * 130 * 4 * 64, generator=g, device=card) \
        .to(torch.bfloat16)
    qo = flat[4:].view(2, 130, 4, 64)
    assert qo.data_ptr() % 16 == 8
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    got = flash_attention(qo, kb, vb, causal=True, q_chunk=130,
                          kv_chunk=130)
    _flash_close(got, flash_attention_plain(qo.contiguous(),
                                            kb.contiguous(),
                                            vb.contiguous()))


@pytest.mark.cuda
def test_standalone_kernels_refuse_what_they_do_not_take(card):
    z = torch.zeros(2, 8, device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="kernel takes"):
        shuffle_cuda(z, z, "interleave")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rope_cuda(z, torch.zeros(2, device=card))
    q = torch.zeros(1, 8, 2, 264, device=card)
    with pytest.raises(ValueError, match="dh=264"):
        flash_attention_cuda(q, q, q)


# ------------------------------------------------------- CPU, no card

@pytest.mark.parametrize("shape,pos_shape", [
    ((2, 16, 3, 64), (2, 16)),        # one position per slot: shared
    ((2, 16, 3, 64), (2, 16, 3)),     # one per row
    ((2, 16, 3, 64), (1, 16)),        # broadcast over the batch
    ((16, 3, 32), (16,)),             # (S, H, dh)
    ((2, 16, 1, 64), (2, 16)),        # one head
])
def test_rope_entry_shares_positions_bitwise(shape, pos_shape):
    """The entry's shared-position rows equal the rows with every
    position written out, bitwise."""
    g = torch.Generator().manual_seed(len(pos_shape))
    x = torch.randn(shape, generator=g)
    pos = torch.randint(0, 4096, pos_shape, generator=g)
    full = (pos[..., None] if pos.ndim == x.ndim - 2 else pos) \
        .broadcast_to(shape[:-1]).reshape(-1)
    want = rope_plain(x.reshape(-1, shape[-1]), full, theta=1e6,
                      layout="neox").reshape(shape)
    assert torch.equal(rope(x, pos, theta=1e6, layout="neox"), want)


def test_rope_refuses_heads_that_do_not_divide_the_rows():
    with pytest.raises(ValueError, match="divide"):
        rope_plain(torch.zeros(6, 8), torch.zeros(1), heads=4)
    with pytest.raises(ValueError, match=r"positions must be \(2,\)"):
        rope_plain(torch.zeros(6, 8), torch.zeros(6), heads=3)


def test_entries_check_before_they_dispatch():
    a = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="unknown shuffle op"):
        shuffle(a, a, "rotate")
    with pytest.raises(ValueError, match="half"):
        shuffle(a, a, "interleave", half="middle")
    with pytest.raises(ValueError, match="power of two"):
        shuffle(torch.zeros(3, 6), torch.zeros(3, 6), "bit_reverse")
    with pytest.raises(ValueError, match="one shape"):
        shuffle(a, torch.zeros(3, 4), "interleave")
    with pytest.raises(ValueError, match="layout"):
        rope(a, torch.zeros(3), layout="gptj")
    with pytest.raises(ValueError, match="dh even"):
        rope(torch.zeros(3, 7), torch.zeros(3))
    q = torch.zeros(1, 96, 2, 8)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, q, q, q_chunk=64)
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q, torch.zeros(1, 96, 3, 8), torch.zeros(1, 96, 3, 8),
                        q_chunk=32, kv_chunk=32)


def test_flash_bfloat16_needs_p_split_into_hi_and_lo():
    """Why the bfloat16 kernel splits P before the tensor-core P V product:
    bfloat16 q, k and v at (1, 1024, 4, 64), causal. P = exp(s - max)
    rounded once to bfloat16 breaks `FLASH_TOL` at some outputs; P as
    bf16(p) + bf16(p - bf16(p)), both products summed in float32, holds
    it everywhere."""
    B, S, H, dh = 1, 1024, 4, 64
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, dh),
                                                    dtype=np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = flash_attention_plain(q, k, v, causal=True).float()
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) / math.sqrt(dh)
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)

    def out(*parts):
        o = sum(torch.einsum("bhqs,bshd->bhqd", x, v.float()) for x in parts)
        return (o / l).transpose(1, 2).to(torch.bfloat16).float()

    atol, rtol = FLASH_TOL["bfloat16"]
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    once = (out(hi) - want).abs() > atol + rtol * want.abs()
    split = (out(hi, lo) - want).abs() > atol + rtol * want.abs()
    assert once.float().mean() > 0.005, once.float().mean()
    assert not split.any(), int(split.sum())


# ------------------------------------- the float32 kernel's 3xTF32 design

_FLASH_CU = (Path(flash_kernel_module.__file__).resolve().parent / "csrc" /
             "flash_attention.cu")


def _f32_const(name: str) -> int:
    """A tile constant of the float32 kernel (namespace f32), read from
    the source."""
    src = _FLASH_CU.read_text()
    body = src[src.index("namespace f32 {"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest on the int32 view, ties away from zero, the low 13 bits 0."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def test_flash_float32_needs_three_tf32_products():
    """Why the float32 kernel runs 3xTF32: float32 q, k and v at (1,
    1024, 4, 64), causal. One TF32 product per matrix product (q, k, p and
    v each rounded once) breaks `FLASH_TOL` at a clear share of outputs;
    a = a_hi + a_lo for every operand, with a_hi b_hi + a_hi b_lo + a_lo
    b_hi summed in float32, holds it at every output."""
    B, S, H, dh = 1, 1024, 4, 64
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((B, S, H, dh), dtype=np.float32)
               for _ in range(3))
    want = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=True)
    qs = q * np.float32(1.0 / math.sqrt(dh))      # q carries the scale

    def halves(x):
        hi = _tf32(x)
        return torch.from_numpy(hi), torch.from_numpy(_tf32(x - hi))

    (qh, ql), (kh, kl), (vh, vl) = halves(qs), halves(k), halves(v)
    mask = torch.ones(S, S, dtype=torch.bool).tril()

    def out(s_terms, pv_terms):
        s = sum(torch.einsum("bqhd,bshd->bhqs", a, b) for a, b in s_terms)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        ph, pl = halves(p.numpy())
        terms = pv_terms(ph, pl)
        o = sum(torch.einsum("bhqs,bshd->bhqd", a, b) for a, b in terms)
        return (o / l).transpose(1, 2)

    atol, rtol = FLASH_TOL["float32"]
    once = out([(qh, kh)], lambda ph, pl: [(ph, vh)])
    split = out([(qh, kh), (qh, kl), (ql, kh)],
                lambda ph, pl: [(ph, vh), (ph, vl), (pl, vh)])
    bad_once = (once - want).abs() > atol + rtol * want.abs()
    bad_split = (split - want).abs() > atol + rtol * want.abs()
    assert bad_once.float().mean() > 0.05, bad_once.float().mean()
    assert not bad_split.any(), int(bad_split.sum())


def _sw128(addr):
    """Byte address in the 128-byte swizzle, as TMA writes a box and a
    wgmma descriptor reads it: bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _land(tile: np.ndarray) -> np.ndarray:
    """A (rows, dhp) tile as it lands in shared memory (TMA boxes of 32
    floats x rows, 128-byte swizzled), as an array of 4-byte words."""
    R, dhp = tile.shape
    r, d = np.meshgrid(np.arange(R), np.arange(dhp), indexing="ij")
    addr = _sw128((d // 32) * (R * 128) + r * 128 + (d % 32) * 4)
    assert len(np.unique(addr)) == addr.size
    mem = np.zeros(R * dhp)
    mem[addr // 4] = tile[r, d]
    return mem


def _desc_words(start: int, rows: int) -> np.ndarray:
    """Word indices of the (rows, 8) K-major operand a wgmma k8 step reads
    through a 128-byte-swizzled descriptor at byte ``start`` (8-row groups
    1024 bytes apart)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    return _sw128(start + (r // 8) * 1024 + (r % 8) * 128 + 4 * k) // 4


@pytest.mark.parametrize("dhp,BK", [(32, 64), (64, 64), (64, 32),
                                    (96, 32), (128, 32), (256, 32)])
def test_flash_float32_layouts_walk_through(dhp, BK):
    """The float32 kernel's shared-memory layouts and fragments walked
    through in numpy with its thread map: the cp.async copies land where
    TMA's boxes do; S = Q K^T through the k-step descriptors; `transpose_v`
    writes V^T split and key-permuted, every 16-byte access of an 8-thread
    phase on 8 distinct bank groups; and P taken from the S accumulator
    as the TF32 A fragment (column t <-> key 2t, t + 4 <-> key 2t + 1)
    times V^T through the descriptors gives P V, in three products. At
    both key tiles the kernel takes (`Shape::BK`: 64 keys at dh <= 64,
    32 above)."""
    BQ = _f32_const("kBQ")
    rng = np.random.default_rng(dhp)
    qt, kt, vt = (rng.standard_normal((R, dhp)).astype(np.float32)
                  for R in (BQ, BK, BK))

    # cp.async (load_rows): chunk c of row r, VB bytes a copy
    for R in (BQ, BK):
        ref = _land(np.arange(R * dhp, dtype=np.float64).reshape(R, dhp))
        for vb in (16, 8, 4):
            per, ncb = 16 // vb, dhp // 32
            mem = np.full(R * dhp, -1.0)
            for i in range(R * ncb * 8 * per):
                r, c = i // (ncb * 8 * per), i % (ncb * 8 * per) // per
                pc = i % per
                col = c * 4 + pc * (vb // 4)
                dst = ((c >> 3) * (R * 128) + r * 128 +
                       (((c & 7) ^ (r & 7)) << 4) + pc * vb)
                for x in range(vb // 4):
                    mem[dst // 4 + x] = r * dhp + col + x
            np.testing.assert_array_equal(mem, ref)

    # S = Q K^T over dhp / 8 k-steps of 8
    qmem, kmem = _land(qt), _land(kt)
    s = np.zeros((BQ, BK))
    for kk in range(dhp // 8):
        qo = (kk >> 2) * (BQ * 128) + (kk & 3) * 32
        ko = (kk >> 2) * (BK * 128) + (kk & 3) * 32
        s += qmem[_desc_words(qo, BQ)] @ kmem[_desc_words(ko, BK)].T
    np.testing.assert_allclose(s, qt.astype(np.float64) @ kt.T, rtol=1e-12,
                               atol=1e-12)

    # transpose_v: V as landed -> V^T_hi, V^T_lo, one unit a thread
    vmem = _land(vt)
    vh, vl = np.full(BK * dhp, np.nan), np.full(BK * dhp, np.nan)
    NH = BK // 32
    units = (BK // 4) * (dhp // 4)
    reads, writes = {}, {}
    for u in range(units):
        e, nl, p = u & 1, (u >> 1) & 3, u >> 3
        n, cb = nl + 4 * ((p >> 3) % NH), (p >> 3) // NH
        cc = ((((nl >> 1) ^ (p >> 1)) & 1) << 2) | \
            ((((nl & 1) ^ (p >> 2)) & 1) << 1) | (p & 1)
        x = []
        for i in range(4):
            r = 8 * n + e + 2 * i
            a = cb * (BK * 128) + r * 128 + ((cc ^ (r & 7)) << 4)
            reads.setdefault((u // 8, i), []).append(a)
            x.append(vmem[a // 4:a // 4 + 4].astype(np.float32))
        sc = 2 * n + e
        for dd in range(4):
            d = 32 * cb + 4 * cc + dd
            off = (sc >> 3) * (dhp * 128) + d * 128 + \
                (((sc & 7) ^ (d & 7)) << 4)
            writes.setdefault((u // 8, dd), []).append(off)
            col = np.array([xi[dd] for xi in x], dtype=np.float32)
            hi = _tf32(col)
            assert np.isnan(vh[off // 4:off // 4 + 4]).all()
            vh[off // 4:off // 4 + 4] = hi
            vl[off // 4:off // 4 + 4] = _tf32(col - hi)
    assert not np.isnan(vh).any()
    for acc in (reads, writes):
        for addrs in acc.values():
            assert len({(a // 16) % 8 for a in addrs}) == len(addrs) == 8

    # P V^T: P from the S accumulator layout (thread (w, lane) holds
    # s[4 n + e] at row 16 w + g + 8 (e / 2), key 8 n + 2 t + e % 2) as
    # A = (p0, p2, p1, p3) per 8-key group, the TF32 A fragment (g, t),
    # (g + 8, t), (g, t + 4), (g + 8, t + 4)
    P = rng.random((BQ, BK)).astype(np.float32)
    ph, pl = _tf32(P), _tf32(P - _tf32(P))
    o = np.zeros((BQ, dhp))
    for kk in range(BK // 8):
        vo = (kk >> 2) * (dhp * 128) + (kk & 3) * 32
        Bh, Bl = vh[_desc_words(vo, dhp)], vl[_desc_words(vo, dhp)]
        for src, Bm in ((ph, Bh), (ph, Bl), (pl, Bh)):
            A = np.zeros((BQ, 8))
            for w in range(BQ // 16):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    r = 16 * w + g
                    # s[4 kk + e] of this thread, e = 0..3
                    se = [src[r + 8 * (e >> 1), 8 * kk + 2 * t + (e & 1)]
                          for e in range(4)]
                    A[r, t], A[r + 8, t] = se[0], se[2]
                    A[r, t + 4], A[r + 8, t + 4] = se[1], se[3]
            o += A @ Bm.T
    want = P.astype(np.float64) @ vt.astype(np.float64)
    np.testing.assert_allclose(o, want, rtol=0, atol=1e-5)
    err_hi_only = np.abs(ph.astype(np.float64) @ _tf32(vt) - want).max()
    assert np.abs(o - want).max() < err_hi_only / 100
