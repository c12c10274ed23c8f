"""11-tap FIR mapped onto the VWR2A simulator (paper §4.4.1).

The input blocks are independent, so they are dealt round-robin to however
many columns the machine has (paper mapping: both columns on different
slices of the input; ``n_columns`` generalizes it).  Each 128-word block
pass stages the current block in VWR A and the previous block in VWR B;
the (k-1)-word boundary reads use the virtual [B;A] window (the
circular-shift boundary delivery of §3.3.1).  Taps are q16.15 immediates
in the configuration words.  21 RC-cycles per output word (1 FXMUL + 10
FXMUL/ADD pairs), MXCU INCK and LCU looping ride in parallel slots.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.archsim.isa import LSUInstr, RCInstr, SlotWord, sweep_words
from repro_torch.archsim.machine import RC_SLICE, VWR_WORDS, VWR2A, to_q15_arr


@functools.lru_cache(maxsize=64)
def _mac_instrs(taps_q15: tuple):
    """The per-output 21-cycle MAC sequence (k-independent)."""
    k_taps = len(taps_q15)
    seq = [RCInstr("FXMUL", ("win", 0), ("imm", taps_q15[0]), ("reg", 0))]
    for i in range(1, k_taps):
        seq.append(RCInstr("FXMUL", ("win", -i), ("imm", taps_q15[i]), None))
        dest = ("vwr", "C", 0) if i == k_taps - 1 else ("reg", 0)
        seq.append(RCInstr("ADD", ("reg", 0), ("rc", 0), dest))
    return tuple(seq)


def gen_fir_block(x_line: int, prev_line: int, out_line: int,
                  taps_q15: tuple):
    """One 128-output FIR pass: LOAD A/B, 32 x 21-cycle MACs, STORE C."""
    instrs = _mac_instrs(tuple(taps_q15))
    words = [
        SlotWord(lsu=LSUInstr("LOAD", "A", ("imm", x_line))),
        SlotWord(lsu=LSUInstr("LOAD", "B", ("imm", prev_line))),
    ]
    for k in range(RC_SLICE):
        words += sweep_words(k, instrs)
    words.append(SlotWord(lsu=LSUInstr("STORE", "C", ("imm", out_line))))
    return words


def run_fir(x: np.ndarray, taps: np.ndarray, *,
            machine: VWR2A | None = None, charge_dma: bool = True,
            n_columns: int | None = None):
    """Simulate the FIR over a real-valued signal (len multiple of 128).
    Returns (y, counters, wall_cycles)."""
    m = machine or VWR2A(n_columns or 2)
    nc = m.n_columns
    n = x.shape[0]
    assert n % VWR_WORDS == 0
    n_lines = n // VWR_WORDS
    out_base = 24                          # output region in the SPM
    assert out_base + n_lines <= 48

    xq = to_q15_arr(x)
    if charge_dma:
        for ln in range(n_lines):
            m.dma_in(ln, xq[ln * VWR_WORDS: (ln + 1) * VWR_WORDS])
    else:
        m.spm[:n_lines] = xq.reshape(n_lines, VWR_WORDS)
    # zero line for the first block's boundary
    ZERO_LINE = 63
    m.spm[ZERO_LINE] = 0

    tq = tuple(int(v) for v in to_q15_arr(np.asarray(taps, np.float64)))
    for ln in range(n_lines):              # columns take alternating blocks
        prev = ZERO_LINE if ln == 0 else ln - 1
        prog = gen_fir_block(ln, prev, out_base + ln, tq)
        progs = [[] for _ in range(nc)]
        progs[ln % nc] = prog
        m.run(progs)

    yq = m.spm[out_base: out_base + n_lines].reshape(-1).copy()
    if charge_dma:
        m.dma_out(out_base, n)
    y = yq.astype(np.float64) / (1 << 15)
    cycles = max(c.counters.cycles for c in m.cols)
    return y, m.counters(), cycles
