"""Radix-2 in-place DIF FFT mapped onto the VWR2A simulator (paper §3.4).

Faithful structure: natural-order input, log2(N) in-place butterfly stages
(14-cycle q16.15 complex butterfly with per-stage /2 scaling — the CMSIS-
style fixed-point discipline; the rival FFT accelerator instead uses 18-bit
dynamic scaling, §4.1), output in BIT-REVERSED order, final shuffle-unit
bit-reversal (paper: "the shuffle unit is again used to reorder the data"),
twiddles staged in the SPM.  The stage's butterfly passes are split
round-robin across however many columns the machine instantiates
(``VWR2A(n_columns=...)``; the paper's Fig. 1 machine is the 2-column
default) — passes within a stage are independent, so wall cycles (the max
over columns) shrink with the column count while total activity is
unchanged.

Mapping notes (DESIGN.md §7):
  * the generator unrolls the per-pair MXCU k pattern; real hardware uses
    nested LCU loops — cycle-equivalent (LCU/MXCU issue in parallel slots);
  * pair strides inside one VWR use mux-network offset indexing (the SRF
    "masking values" of paper §3.2); when the pair stride exceeds an RC
    slice, inactive RCs issue NOPs (their cycles are still charged);
  * the final bit-reversal permutation is applied host-side with the exact
    shuffle/LSU cycle charge (2 LOAD + 2 SHUFFLE + 2 STORE per line pair).

Complex layout: word 2j = Re[j], word 2j+1 = Im[j], q16.15.
Output is scaled by 1/N (per-stage halving), like CMSIS-DSP cfft_q15.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.archsim.isa import LSUInstr, RCInstr, SlotWord, sweep_words
from repro_torch.archsim.machine import (RC_SLICE, VWR_WORDS, VWR2A, split_work,
                                   to_q15_arr)

CPLX_PER_LINE = VWR_WORDS // 2      # 64 complex per SPM line
BFLY_CYCLES = 14
TW_LINES = 4                        # twiddle staging lines (one per column)


@functools.lru_cache(maxsize=None)
def _butterfly_instrs(a_src: str, b_src: str, off_b: int):
    """14 per-cycle RC instructions: scaled q15 butterfly at shared k.
    a=(A[k],A[k+1]); b=({b},[k+off_b],+1); w=(C[k],C[k+1]).
    t0=(a+b)/2 -> a slot; t1=((a-b)/2)*w -> b slot."""
    A0, A1 = ("vwr", a_src, 0), ("vwr", a_src, 1)
    B0, B1 = ("vwr", b_src, off_b), ("vwr", b_src, off_b + 1)
    W0, W1 = ("vwr", "C", 0), ("vwr", "C", 1)
    one = ("imm", 1)
    return (
        RCInstr("SUB", A0, B0, ("reg", 0)),
        RCInstr("SRA", ("reg", 0), one, ("reg", 0)),      # dr/2
        RCInstr("SUB", A1, B1, ("reg", 1)),
        RCInstr("SRA", ("reg", 1), one, ("reg", 1)),      # di/2
        RCInstr("ADD", A0, B0, None),
        RCInstr("SRA", ("rc", 0), one, ("vwr", a_src, 0)),            # t0r
        RCInstr("ADD", A1, B1, None),
        RCInstr("SRA", ("rc", 0), one, ("vwr", a_src, 1)),            # t0i
        RCInstr("FXMUL", ("reg", 0), W0, ("vwr", b_src, off_b)),      # dr*wr
        RCInstr("FXMUL", ("reg", 1), W1, None),                       # di*wi
        RCInstr("SUB", ("vwr", b_src, off_b), ("rc", 0),
                ("vwr", b_src, off_b)),                               # t1r
        RCInstr("FXMUL", ("reg", 0), W1, ("reg", 0)),                 # dr*wi
        RCInstr("FXMUL", ("reg", 1), W0, ("reg", 1)),                 # di*wr
        RCInstr("ADD", ("reg", 0), ("reg", 1),
                ("vwr", b_src, off_b + 1)),                           # t1i
    )


@functools.lru_cache(maxsize=2048)
def gen_pass(a_line: int, b_line: int, w_line: int, *,
             inline_stride_c: int = 0):
    """One butterfly pass. Cross-line (inline_stride_c=0): A[j] pairs B[j]
    elementwise. Inline: pairs (c, c+sc) within line a_line.  Memoized —
    callers must treat the returned list as immutable."""
    words = [
        SlotWord(lsu=LSUInstr("LOAD", "A", ("imm", a_line))),
        SlotWord(lsu=LSUInstr("LOAD", "C", ("imm", w_line))),
    ]
    if inline_stride_c == 0:
        words.insert(1, SlotWord(lsu=LSUInstr("LOAD", "B", ("imm", b_line))))
        instrs = _butterfly_instrs("A", "B", 0)
        for k in range(0, RC_SLICE, 2):           # 16 complex per slice
            words += sweep_words(k, instrs)
        words.append(SlotWord(lsu=LSUInstr("STORE", "A", ("imm", a_line))))
        words.append(SlotWord(lsu=LSUInstr("STORE", "B", ("imm", b_line))))
    else:
        sc = inline_stride_c
        instrs = _butterfly_instrs("A", "A", 2 * sc)
        for k in range(0, RC_SLICE, 2):
            # RC r handles complex c = 16r + k/2; active iff c is pair-lower
            active = tuple(((16 * r + k // 2) % (2 * sc)) < sc
                           for r in range(4))
            if any(active):
                words += sweep_words(k, instrs, active)
        words.append(SlotWord(lsu=LSUInstr("STORE", "A", ("imm", a_line))))
    return words


def _write_twiddles(m: VWR2A, line: int, base_c: int, sc: int):
    c = np.arange(CPLX_PER_LINE) + base_c
    j = c % (2 * sc)
    ang = -2 * np.pi * j / (2 * sc)
    tw = np.zeros(VWR_WORDS, np.int64)
    tw[0::2] = to_q15_arr(np.cos(ang))
    tw[1::2] = to_q15_arr(np.sin(ang))
    m.spm[line] = tw


def run_fft(n: int, x: np.ndarray, *, machine: VWR2A | None = None,
            charge_dma: bool = True, n_columns: int | None = None):
    """Simulate an n-point complex FFT (n complex = 2n words <= data SPM).
    Returns (X (complex, scaled back up), counters, wall_cycles)."""
    m = machine or VWR2A(n_columns or 2)
    nc = m.n_columns
    stages = int(np.log2(n))
    assert 1 << stages == n
    n_lines = max(1, (2 * n) // VWR_WORDS)
    assert n_lines + 2 <= 48, "fits the 32 KiB SPM"

    words = np.zeros(max(2 * n, VWR_WORDS), np.int64)
    words[0: 2 * n: 2] = to_q15_arr(x.real)
    words[1: 2 * n: 2] = to_q15_arr(x.imag)
    if charge_dma:
        for ln in range(n_lines):
            m.dma_in(ln, words[ln * VWR_WORDS: (ln + 1) * VWR_WORDS])
    else:
        m.spm[:n_lines] = words[: n_lines * VWR_WORDS].reshape(
            n_lines, VWR_WORDS)

    TW = 60                                # twiddle staging lines
    for s in range(stages):
        sc = n >> (s + 1)                  # pair stride (complex)
        passes = []
        if 2 * sc >= VWR_WORDS:            # cross-line stage
            # pairs of lines (l, l + sc_lines) within blocks of 2*sc_lines
            sc_l = max(1, sc // CPLX_PER_LINE)
            blk = 2 * sc_l
            for b0 in range(0, n_lines, blk):
                for off in range(sc_l):
                    passes.append(("x", b0 + off, b0 + off + sc_l))
        else:
            for ln in range(n_lines):
                passes.append(("i", ln, sc))

        for pi, p in enumerate(passes):
            ci = pi % nc                   # round-robin over columns
            tl = TW + (ci % TW_LINES)
            if p[0] == "x":
                _, al, bl = p
                _write_twiddles(m, tl, al * CPLX_PER_LINE, sc)
                prog = gen_pass(al, bl, tl)
            else:
                _, ln, scc = p
                _write_twiddles(m, tl, ln * CPLX_PER_LINE, scc)
                prog = gen_pass(ln, ln, tl, inline_stride_c=scc)
            progs = [[] for _ in range(nc)]
            progs[ci] = prog
            m.run(progs)

    # final bit-reversal: exact shuffle-unit cycle charge FIRST (the charge
    # loop executes real LSU ops that scribble over lines 0-1), then the
    # host-side permutation writes the semantically-correct result.  Line
    # pairs are reordered by whichever column is free next.
    flat = m.spm[:n_lines].reshape(-1).copy()
    for it in range(max(1, n_lines // 2)):
        col = m.cols[it % nc]
        for w in [SlotWord(lsu=LSUInstr("LOAD", "A", ("imm", 0))),
                  SlotWord(lsu=LSUInstr("LOAD", "B", ("imm", 1))),
                  SlotWord(lsu=LSUInstr("SHUFFLE", "C",
                                        shuffle_op="bit_reverse",
                                        half="lower")),
                  SlotWord(lsu=LSUInstr("STORE", "C", ("imm", 0))),
                  SlotWord(lsu=LSUInstr("SHUFFLE", "C",
                                        shuffle_op="bit_reverse",
                                        half="upper")),
                  SlotWord(lsu=LSUInstr("STORE", "C", ("imm", 1)))]:
            col.step(w)
    cplx = flat[0: 2 * n: 2] + 1j * flat[1: 2 * n: 2]
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(stages):
        rev |= ((idx >> b) & 1) << (stages - 1 - b)
    cplx = cplx[rev]
    out = flat.copy()
    out[0: 2 * n: 2], out[1: 2 * n: 2] = cplx.real, cplx.imag
    m.spm[:n_lines] = out.reshape(n_lines, VWR_WORDS)

    res = m.dma_out(0, 2 * n) if charge_dma else \
        m.spm[:n_lines].reshape(-1)[: 2 * n].copy()
    X = (res[0::2] + 1j * res[1::2]).astype(np.complex128) / (1 << 15) * n
    cycles = max(c.counters.cycles for c in m.cols)
    return X, m.counters(), cycles


def run_rfft(n: int, x_real: np.ndarray, *, machine: VWR2A | None = None,
             n_columns: int | None = None):
    """Real FFT via the paper's packing (§3.4): N real -> N/2 complex FFT +
    untangle. Untangle numerics host-side; cycles charged at 12 RC-ops per
    output element spread over all columns x 4 RCs (DESIGN.md §7)."""
    m = machine or VWR2A(n_columns or 2)
    nc = m.n_columns
    z = x_real[0::2] + 1j * x_real[1::2]
    Z, _, _ = run_fft(n // 2, z, machine=m)
    Z = Z / (n // 2)                       # undo decode upscale
    half = n // 2
    k = np.arange(half)
    Zc = np.conj(Z[(-k) % half])
    w = np.exp(-2j * np.pi * k / n)
    X = 0.5 * (Z + Zc) - 0.5j * w * (Z - Zc)
    nyq = np.array([Z[0].real - Z[0].imag])
    X_full = np.concatenate([X, nyq]) * half
    spm_lines = split_work(2 * max(1, half // CPLX_PER_LINE), nc)
    for col, elems, lines in zip(m.cols, split_work(half, nc), spm_lines):
        col.counters.cycles += -(-12 * elems // 4)
        col.counters.rc_ops += 12 * elems
        col.counters.rc_mults += 4 * elems
        col.counters.vwr_reads += 6 * elems
        col.counters.vwr_writes += 2 * elems
        col.counters.spm_line_reads += lines
        col.counters.spm_line_writes += lines
    cycles = max(c.counters.cycles for c in m.cols)
    return X_full, m.counters(), cycles
