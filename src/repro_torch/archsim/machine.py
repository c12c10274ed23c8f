"""Cycle-accurate functional simulator of one VWR2A column (paper §3).

Geometry (paper):
  * SPM: 32 KiB, wide port = 4096 bit => 64 lines x 128 32-bit words
  * VWRs: A, B, C — 128 words each, single-ported, 1-cycle wide fill
  * 4 RCs x (32-bit ALU + 2-entry regfile); RC r owns VWR slice
    [32r, 32(r+1)); all RCs share the MXCU word index k (paper §3.3.2)
  * SRF: 8 x 32-bit
  * fixed-point 16.15 single-cycle multiply (FXMUL)
  * shuffle unit: C <- op(A, B) (paper §3.3.1)

The machine executes real arithmetic (int32 wraparound / q16.15) so kernel
programs produce checkable numerics; every cycle increments activity
counters consumed by the Table-3-calibrated energy model (energy.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.archsim.isa import SlotWord

VWR_WORDS = 128
SPM_LINES = 64                  # 64 x 128 words x 4 B = 32 KiB
RC_SLICE = VWR_WORDS // 4       # 32 words per RC
Q15 = 15

_I32_MASK = np.int64(0xFFFFFFFF)


def _wrap32(x) -> np.int64:
    x = np.int64(x) & _I32_MASK
    return np.int64(x - (np.int64(1) << 32)) if x >= (np.int64(1) << 31) else np.int64(x)


def to_q15(x: float) -> int:
    return int(np.clip(round(x * (1 << Q15)), -(1 << 31), (1 << 31) - 1))


def to_q15_arr(x) -> np.ndarray:
    """Vectorized to_q15: bit-identical (incl. round-half-to-even)."""
    q = np.round(np.asarray(x, np.float64) * (1 << Q15))
    return np.clip(q, -(1 << 31), (1 << 31) - 1).astype(np.int64)


def split_work(total: int, n_parts: int) -> list:
    """Deal `total` units over `n_parts` columns, remainder to the first
    columns — per-column host-side cycle charges must conserve the total
    for ANY column count (the energy model integrates activity)."""
    base, rem = divmod(total, n_parts)
    return [base + (i < rem) for i in range(n_parts)]


def from_q15(x) -> float:
    return float(np.int64(x)) / (1 << Q15)


@dataclasses.dataclass
class Counters:
    cycles: int = 0
    rc_ops: int = 0
    rc_mults: int = 0
    vwr_reads: int = 0
    vwr_writes: int = 0
    spm_line_reads: int = 0
    spm_line_writes: int = 0
    srf_accesses: int = 0
    shuffles: int = 0
    dma_words: int = 0

    def merged(self, o: "Counters") -> "Counters":
        return Counters(**{f.name: getattr(self, f.name) + getattr(o, f.name)
                           for f in dataclasses.fields(Counters)})


class Column:
    """One VWR2A column: shared PC, 4 RCs, LSU, MXCU, LCU, 3 VWRs."""

    def __init__(self, spm: np.ndarray, srf: np.ndarray):
        self.spm = spm                        # (SPM_LINES, VWR_WORDS) int64
        self.srf = srf                        # (8,) int64 (shared)
        self.vwr = {n: np.zeros(VWR_WORDS, np.int64) for n in "ABC"}
        self.rc_regs = np.zeros((4, 2), np.int64)
        self.rc_last = np.zeros(4, np.int64)  # previous-cycle results
        self.lcu_regs = np.zeros(4, np.int64)
        self.k = 0                            # MXCU word index within slice
        self.pc = 0
        self.counters = Counters()
        self.halted = False

    # ---- operand resolution ----
    def _read(self, rc_idx: int, src, new_last) -> np.int64:
        kind = src[0]
        if kind == "zero":
            return np.int64(0)
        if kind == "imm":
            return np.int64(src[1])
        if kind == "reg":
            return self.rc_regs[rc_idx, src[1]]
        if kind == "srf":
            self.counters.srf_accesses += 1
            return self.srf[src[1]]
        if kind == "rc":
            return self.rc_last[(rc_idx + src[1]) % 4]
        if kind == "vwr":
            # ("vwr", name[, offset]): word (rc*32 + k + offset) of the VWR.
            # Non-zero offsets may cross RC slices — the paper's mux network
            # with SRF-held "masking values for the VWRs index computation"
            # (§3.2); modeling note in DESIGN.md.
            off = src[2] if len(src) > 2 else 0
            self.counters.vwr_reads += 1
            return self.vwr[src[1]][(rc_idx * RC_SLICE + self.k + off)
                                    % VWR_WORDS]
        if kind == "win":
            # ("win", offset): virtual 256-word window concat(B, A) indexed
            # at 128 + rc*32 + k + offset — boundary words for FIR/conv
            self.counters.vwr_reads += 1
            g = VWR_WORDS + rc_idx * RC_SLICE + self.k + src[1]
            cat = self.vwr["B"] if g < VWR_WORDS else self.vwr["A"]
            return cat[g % VWR_WORDS]
        raise ValueError(src)

    def _alu(self, op: str, a: np.int64, b: np.int64) -> np.int64:
        if op in ("NOP", "MOV"):
            return a
        if op == "ADD":
            return _wrap32(a + b)
        if op == "SUB":
            return _wrap32(a - b)
        if op == "MUL":
            return _wrap32(a * b)
        if op == "FXMUL":      # q16.15: drop 15 LSBs, keep next 32 (paper §3.1)
            return _wrap32((np.int64(a) * np.int64(b)) >> Q15)
        if op == "SLL":
            return _wrap32(a << (b & 31))
        if op == "SRL":
            return _wrap32((np.int64(a) & _I32_MASK) >> (b & 31))
        if op == "SRA":
            return _wrap32(np.int64(a) >> (b & 31))
        if op == "AND":
            return np.int64(a) & np.int64(b)
        if op == "OR":
            return np.int64(a) | np.int64(b)
        if op == "XOR":
            return np.int64(a) ^ np.int64(b)
        if op == "MAX":
            return np.int64(max(a, b))
        if op == "MIN":
            return np.int64(min(a, b))
        raise ValueError(op)

    # ---- per-cycle slot execution ----
    def step(self, word: SlotWord):
        c = self.counters
        c.cycles += 1

        # MXCU first (paper: k addresses this cycle's VWR accesses)
        mx = word.mxcu
        if mx.op == "SETK":
            self.k = mx.k
        elif mx.op == "INCK":
            self.k = (self.k + 1) % RC_SLICE
        elif mx.op == "ADDK":
            self.k = (self.k + mx.k) % RC_SLICE

        # RCs
        new_last = self.rc_last.copy()
        for i, rc in enumerate(word.rcs):
            if rc.op == "NOP":
                continue
            a = self._read(i, rc.a, new_last)
            b = self._read(i, rc.b, new_last)
            r = self._alu(rc.op, a, b)
            c.rc_ops += 1
            if rc.op in ("MUL", "FXMUL"):
                c.rc_mults += 1
            new_last[i] = r
            if rc.dest is not None:
                d = rc.dest
                if d[0] == "reg":
                    self.rc_regs[i, d[1]] = r
                elif d[0] == "vwr":
                    off = d[2] if len(d) > 2 else 0
                    self.vwr[d[1]][(i * RC_SLICE + self.k + off)
                                   % VWR_WORDS] = r
                    c.vwr_writes += 1
                elif d[0] == "srf":
                    self.srf[d[1]] = r
                    c.srf_accesses += 1
        self.rc_last = new_last

        # LSU
        ls = word.lsu
        if ls.op != "NOP":
            if ls.op in ("LOAD", "STORE"):
                addr = int(self.srf[ls.addr[1]] if ls.addr[0] == "srf"
                           else ls.addr[1]) % SPM_LINES
                if ls.op == "LOAD":
                    self.vwr[ls.vwr][:] = self.spm[addr]
                    c.spm_line_reads += 1
                    c.vwr_writes += VWR_WORDS // VWR_WORDS  # 1 wide fill
                else:
                    self.spm[addr] = self.vwr[ls.vwr]
                    c.spm_line_writes += 1
                    c.vwr_reads += 1
            elif ls.op == "SHUFFLE":
                a, b = self.vwr["A"], self.vwr["B"]
                cat = np.concatenate([a, b])
                op = ls.shuffle_op
                if op == "interleave":
                    out = np.stack([a, b], axis=1).reshape(-1)
                elif op == "prune_even":
                    out = np.concatenate([a[1::2], b[1::2], a[1::2], b[1::2]])
                elif op == "prune_odd":
                    out = np.concatenate([a[0::2], b[0::2], a[0::2], b[0::2]])
                elif op == "bit_reverse":
                    n = cat.shape[0]
                    bits = int(np.log2(n))
                    idx = np.arange(n)
                    rev = np.zeros(n, np.int64)
                    for bb in range(bits):
                        rev |= ((idx >> bb) & 1) << (bits - 1 - bb)
                    out = cat[rev]
                elif op == "circular_shift":
                    out = np.roll(cat, 32)
                else:
                    raise ValueError(op)
                half = out[:VWR_WORDS] if ls.half == "lower" else out[VWR_WORDS:]
                self.vwr["C"][:] = half
                c.shuffles += 1
                c.vwr_reads += 2
                c.vwr_writes += 1
            elif ls.op == "LOAD_SRF":
                addr = int(ls.addr[1]) % (SPM_LINES * VWR_WORDS)
                self.srf[ls.vwr if isinstance(ls.vwr, int) else 0] = \
                    self.spm[addr // VWR_WORDS, addr % VWR_WORDS]
                c.srf_accesses += 1

        # LCU last (controls next PC)
        lc = word.lcu
        next_pc = self.pc + 1
        if lc.op == "SETI":
            self.lcu_regs[lc.reg] = lc.val
        elif lc.op == "ADDI":
            self.lcu_regs[lc.reg] = _wrap32(self.lcu_regs[lc.reg] + lc.val)
        elif lc.op == "BLT":
            if self.lcu_regs[lc.reg] < lc.val:
                next_pc = lc.target
        elif lc.op == "BGE":
            if self.lcu_regs[lc.reg] >= lc.val:
                next_pc = lc.target
        elif lc.op == "JUMP":
            next_pc = lc.target
        elif lc.op == "EXIT":
            self.halted = True
        self.pc = next_pc


class VWR2A:
    """N columns + shared SPM/SRF + DMA counter.  The paper's Fig. 1
    instance is ``n_columns=2`` (the default); the machine is
    parameterized the way Ara scales vector lanes / STRELA scales CGRA
    columns, so kernel mappings can sweep column counts.

    ``engine`` selects the interpreter: ``"vector"`` (default) runs
    straight-line k-sweep programs as NumPy array ops over all 4 RCs x
    sweep instances at once (bit-exact counters and numerics, see
    vector.py); ``"scalar"`` forces the word-at-a-time reference path.
    """

    def __init__(self, n_columns: int = 2, engine: str = "vector"):
        assert n_columns >= 1
        assert engine in ("vector", "scalar"), engine
        self.spm = np.zeros((SPM_LINES, VWR_WORDS), np.int64)
        self.srf = np.zeros(8, np.int64)
        self.cols = [Column(self.spm, self.srf) for _ in range(n_columns)]
        self.engine = engine

    @property
    def n_columns(self) -> int:
        return len(self.cols)

    def dma_in(self, line: int, words: np.ndarray):
        """System memory -> SPM (word-granular DMA, counted per word)."""
        n = words.shape[0]
        self.spm.reshape(-1)[line * VWR_WORDS: line * VWR_WORDS + n] = words
        self.cols[0].counters.dma_words += n

    def dma_out(self, line: int, n: int) -> np.ndarray:
        self.cols[0].counters.dma_words += n
        return self.spm.reshape(-1)[line * VWR_WORDS: line * VWR_WORDS + n].copy()

    def run(self, programs, max_cycles: int = 1_000_000,
            engine: str | None = None):
        """programs: list of per-column instruction lists (SlotWords).
        Shorter lists are padded with empty programs."""
        programs = list(programs)
        assert len(programs) <= len(self.cols), "more programs than columns"
        programs += [[] for _ in range(len(self.cols) - len(programs))]

        engine = engine or self.engine
        active = [(c, p) for c, p in zip(self.cols, programs) if p]
        # The vectorized path reorders execution within one column; with
        # two or more concurrently-active columns the scalar lockstep
        # interleaving over shared SPM/SRF must be preserved exactly, so
        # only single-active-column runs (the shape every generated
        # kernel pass uses) take the fast path.
        if engine == "vector" and len(active) == 1:
            from repro_torch.archsim import vector

            col, prog = active[0]
            if len(prog) <= max_cycles:
                items = vector.compile_program(prog)
                if items is not None:
                    for c, p in zip(self.cols, programs):
                        c.pc = 0
                        c.halted = not p
                    vector.run_compiled(col, prog, items)
                    return self.counters()

        for col, prog in zip(self.cols, programs):
            col.pc = 0
            col.halted = not prog
        cycles = 0
        while cycles < max_cycles:
            live = False
            for col, prog in zip(self.cols, programs):
                if col.halted:
                    continue
                if col.pc >= len(prog):
                    col.halted = True
                    continue
                col.step(prog[col.pc])
                live = live or not col.halted
            cycles += 1
            if not live:
                break
        return self.counters()

    def counters(self) -> Counters:
        out = Counters()
        for col in self.cols:
            out = out.merged(col.counters)
        return out
