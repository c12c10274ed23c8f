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
  (sums run in another order), and 1e-4 + 2^-7 |plain| in bfloat16: both
  round the float32 result once, so they differ by at most one bfloat16
  step (<= 2^-7 |plain|) plus the float32 difference; `chip_smoke.py`
  holds the full-size runs to the same limits.

The CPU tests at the end check what the entries refuse before anything is
built, and why the bfloat16 kernel splits P into two bfloat16 halves."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
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


# -------------------------------------------------------- flash attention

def _flash_close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    atol, rtol = FLASH_TOL[str(want.dtype).replace("torch.", "")]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 128, 128, 4, 2, 64), True, None),     # GQA group 2
    ((1, 200, 200, 4, 1, 120), True, None),    # MQA, S % 64 != 0, dh 120
    ((2, 256, 256, 4, 2, 32), True, 96),       # sliding window
    ((1, 150, 150, 2, 2, 24), True, 32),       # window inside one tile
    ((1, 96, 160, 4, 2, 64), False, None),     # Sq < Skv, no mask
    ((1, 160, 96, 4, 4, 128), False, None),    # Sq > Skv, no mask
    ((1, 100, 100, 2, 1, 256), False, 40),     # window without causal
    ((1, 130, 130, 4, 2, 20), True, None),     # dh 20: 40-byte rows
    ((1, 1, 777, 4, 2, 64), False, None),      # one partial query tile
    ((1, 64, 4096, 4, 2, 64), True, 64),       # nearly every tile off-band
    ((8, 65, 65, 32, 8, 64), True, None),      # many heads, short S
    ((1, 150, 150, 4, 2, 200), True, None),    # dh 200: N % 16 != 0
    ((1, 90, 90, 2, 1, 18), True, None),       # dh 18: 4-byte copies
    ((1, 90, 90, 2, 1, 25), False, 30),        # dh 25: 2-byte copies
])
def test_flash_kernel_matches_plain_on_card(card, shape, causal, window,
                                            dtype):
    B, Sq, Skv, H, KV, dh = shape
    g = torch.Generator(device=card).manual_seed(Sq + dh)
    q = torch.randn(B, Sq, H, dh, generator=g, device=card).to(dtype)
    k = torch.randn(B, Skv, KV, dh, generator=g, device=card).to(dtype)
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
