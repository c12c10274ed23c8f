"""NumPy-vectorized execution engine for the VWR2A simulator.

The scalar interpreter (``machine.Column.step``) executes one SlotWord at
a time, one RC at a time, in pure Python.  Generated kernel programs are
dominated by *k-sweeps*: the same per-RC instruction sequence repeated
for every MXCU word index k (a ``SETK`` word followed by mxcu-NOP body
words).  This module compiles a straight-line program into groups of such
packets and executes every instance of a group simultaneously as NumPy
array ops over (instances x 4 RC lanes).

Equivalence guarantee: the vectorized engine is *bit-exact* against the
scalar engine — identical int32-wraparound / q16.15 numerics AND identical
activity counters (cycles, rc_ops, vwr/spm accesses, ...), so the
Table-3-calibrated energy model is unchanged.  A static hazard analysis
(`_analyze`) proves, per group, that the reordering from "instance 0
fully, then instance 1, ..." to "step 0 for all instances, then step 1,
..." is unobservable; anything it cannot prove falls back to the scalar
path word-for-word.  All RC addressing is k-static (no data-dependent
addresses), which is what makes the analysis exact rather than
heuristic.

Hazard rules (all checked statically, per candidate group):
  * register / previous-result reads must be defined earlier in the same
    packet instance (no cross-instance register carry);
  * a lane reading a lower lane's result in the same cycle is rejected
    out of conservatism (the scalar engine reads ("rc", d) from rc_last,
    i.e. the *previous* cycle, so forwarding never happens there — do
    not "match scalar" by forwarding here);
  * no VWR word written by one instance may be read or written by any
    other instance, and no same-cycle cross-lane VWR forwarding (VWR
    writes DO land within the scalar cycle, lane-ascending);
  * RC dests other than registers/VWR words (SRF is shared state) are
    rejected.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# geometry (mirrors machine.py; imported lazily there to avoid a cycle)
VWR_WORDS = 128
RC_SLICE = VWR_WORDS // 4
Q15 = 15

_I32_MASK = np.int64(0xFFFFFFFF)
_BIAS = np.int64(1) << 31


def _wrap32v(x: np.ndarray) -> np.ndarray:
    """Vectorized twin of machine._wrap32 (two's-complement int32)."""
    return ((x + _BIAS) & _I32_MASK) - _BIAS


def _alu_vec(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if op in ("NOP", "MOV"):
        return a
    if op == "ADD":
        return _wrap32v(a + b)
    if op == "SUB":
        return _wrap32v(a - b)
    if op == "MUL":
        return _wrap32v(a * b)
    if op == "FXMUL":
        return _wrap32v((a * b) >> Q15)
    if op == "SLL":
        return _wrap32v(a << (b & 31))
    if op == "SRL":
        return _wrap32v((a & _I32_MASK) >> (b & 31))
    if op == "SRA":
        return _wrap32v(a >> (b & 31))
    if op == "AND":
        return a & b
    if op == "OR":
        return a | b
    if op == "XOR":
        return a ^ b
    if op == "MAX":
        return np.maximum(a, b)
    if op == "MIN":
        return np.minimum(a, b)
    raise ValueError(op)


def _resolve_vwr(src, r: int, k: int):
    """Static (vwr_name, word_index) for a k-addressed operand/dest."""
    kind = src[0]
    if kind == "vwr":
        off = src[2] if len(src) > 2 else 0
        return src[1], (r * RC_SLICE + k + off) % VWR_WORDS
    if kind == "win":
        g = VWR_WORDS + r * RC_SLICE + k + src[1]
        return ("B" if g < VWR_WORDS else "A"), g % VWR_WORDS
    raise ValueError(src)


@dataclasses.dataclass
class _Packet:
    """One SETK-headed k-sweep instance: shared instr per step + lane mask."""
    k: int
    instrs: tuple                # per-step RCInstr or None (all lanes NOP)
    mask: np.ndarray             # (P, 4) bool
    words: list                  # original SlotWords (scalar fallback)


@dataclasses.dataclass
class VecGroup:
    """A hazard-checked batch of packet instances, executable step-major."""
    instrs: tuple                # per-step RCInstr or None
    ks: np.ndarray               # (K,) int
    mask: np.ndarray             # (K, P, 4) bool
    deltas: dict                 # counter increments (exact scalar match)
    reg_commit: list             # [((r, j), instance), ...]
    last_commit: list            # [(r, instance), ...]
    final_k: int
    plans: list = None           # per-step precomputed gather/scatter plans


def _make_packet(words, k: int):
    """Packet iff every cycle's non-NOP RCs share one instruction."""
    instrs, mask = [], np.zeros((len(words), 4), bool)
    for s, w in enumerate(words):
        instr = None
        for r, rc in enumerate(w.rcs):
            if rc.op == "NOP":
                continue
            if instr is None:
                instr = rc
            elif rc is not instr and rc != instr:
                return None
            mask[s, r] = True
        instrs.append(instr)
    return _Packet(k, tuple(instrs), mask, list(words))


def _analyze(instrs, ks, masks):
    """Prove instance-major == step-major for this group; compute the exact
    counter deltas and final register/result commits.  Returns None when
    any hazard rule fails (caller falls back to the scalar engine)."""
    P, K = len(instrs), len(ks)
    writes = {}                       # (vwr, idx) -> writer instance
    reads = {}                        # (vwr, idx) -> set of instances
    d_rc_ops = d_mults = d_vwr_r = d_vwr_w = d_srf = 0
    reg_writer, last_writer = {}, {}
    for i in range(K):
        k = ks[i]
        reg_def, last_def = set(), set()
        for s in range(P):
            ins = instrs[s]
            if ins is None:
                continue
            row = masks[i][s]
            step_writes = {}
            for r in range(4):
                if not row[r]:
                    continue
                for src in (ins.a, ins.b):
                    kind = src[0]
                    if kind == "reg":
                        if (r, src[1]) not in reg_def:
                            return None
                    elif kind == "rc":
                        sr = (r + src[1]) % 4
                        if sr not in last_def:
                            return None
                        if sr < r and row[sr]:   # conservative (see
                            return None          # module docstring)
                    elif kind in ("vwr", "win"):
                        addr = _resolve_vwr(src, r, k)
                        if addr in step_writes:  # written by a lower lane
                            return None          # this same cycle
                        reads.setdefault(addr, set()).add(i)
                        d_vwr_r += 1
                    elif kind == "srf":
                        d_srf += 1
                d = ins.dest
                if d is not None:
                    if d[0] == "reg":
                        reg_def.add((r, d[1]))
                        reg_writer[(r, d[1])] = i
                    elif d[0] == "vwr":
                        addr = _resolve_vwr(d, r, k)
                        if addr in step_writes:  # same-cycle double write
                            return None
                        step_writes[addr] = r
                        prev = writes.get(addr)
                        if prev is not None and prev != i:
                            return None
                        writes[addr] = i
                        d_vwr_w += 1
                    else:
                        # srf writes touch shared state; any other dest
                        # kind is outside the proven subset — scalar path
                        return None
                last_def.add(r)
                last_writer[r] = i
                d_rc_ops += 1
                if ins.op in ("MUL", "FXMUL"):
                    d_mults += 1
    for addr, wi in writes.items():
        if any(j != wi for j in reads.get(addr, ())):
            return None                          # cross-instance RAW/WAR
    deltas = {"cycles": K * P, "rc_ops": d_rc_ops, "rc_mults": d_mults,
              "vwr_reads": d_vwr_r, "vwr_writes": d_vwr_w,
              "srf_accesses": d_srf}
    return (deltas, sorted(reg_writer.items()), sorted(last_writer.items()))


def _build_plans(instrs, ks, mask):
    """Precompute per-step gather/scatter index arrays (k-static)."""
    K = len(ks)
    base = np.arange(4) * RC_SLICE                        # (4,)
    kcol = np.asarray(ks, np.int64)[:, None]              # (K, 1)

    def operand_plan(src):
        kind = src[0]
        if kind == "zero":
            return ("imm", np.int64(0))
        if kind == "imm":
            return ("imm", np.int64(src[1]))
        if kind == "reg":
            return ("reg", src[1])
        if kind == "srf":
            return ("srf", src[1])
        if kind == "rc":
            return ("rc", (np.arange(4) + src[1]) % 4)
        if kind == "vwr":
            off = src[2] if len(src) > 2 else 0
            idx = (base[None, :] + kcol + off) % VWR_WORDS
            return ("vwr", src[1], idx)
        if kind == "win":
            g = VWR_WORDS + base[None, :] + kcol + src[1]
            return ("win", g < VWR_WORDS, g % VWR_WORDS)
        raise ValueError(src)

    plans = []
    for s, ins in enumerate(instrs):
        if ins is None or not mask[:, s, :].any():
            plans.append(None)
            continue
        m = mask[:, s, :]
        dest = None
        if ins.dest is not None:
            if ins.dest[0] == "reg":
                dest = ("reg", ins.dest[1])
            else:                                          # ("vwr", ...)
                off = ins.dest[2] if len(ins.dest) > 2 else 0
                idx = (base[None, :] + kcol + off) % VWR_WORDS
                dest = ("vwr", ins.dest[1], idx[m])        # flat, masked
        plans.append((ins.op, operand_plan(ins.a), operand_plan(ins.b),
                      dest, m))
    return plans


# Group-level compile cache: identical k-sweeps recur across passes/blocks
# (every FFT stage pass, every FIR block).  Keyed by value, bounded.
_GROUP_CACHE: dict = {}
_GROUP_CACHE_MAX = 256

# Packet cache keyed by word identity: isa.sweep_words hands every pass the
# same SlotWord objects for a repeated sweep, so the (id, ...) tuple is a
# stable key.  Values pin the word list, keeping the ids valid.
_PACKET_CACHE: dict = {}
_PACKET_CACHE_MAX = 4096


def _packet_for(words, k: int):
    key = (k,) + tuple(map(id, words))
    hit = _PACKET_CACHE.get(key)
    if hit is not None:
        return hit[1]
    p = _make_packet(words, k)
    if len(_PACKET_CACHE) < _PACKET_CACHE_MAX:
        _PACKET_CACHE[key] = (list(words), p)
    return p


def _group_packets(packets):
    """Greedy grouping of consecutive same-instruction packets; each safe
    group becomes a VecGroup, anything else degrades to scalar words."""
    items = []
    i = 0
    while i < len(packets):
        j = i + 1
        while j < len(packets) and packets[j].instrs == packets[i].instrs:
            j += 1
        run = packets[i:j]
        if len(run) < 2:                       # no win batching 1 instance
            for p in run:
                items.extend(p.words)
            i = j
            continue
        ks = tuple(p.k for p in run)
        mask = np.stack([p.mask for p in run])              # (K, P, 4)
        key = (run[0].instrs, ks, mask.tobytes())
        group = _GROUP_CACHE.get(key)
        if group is None and key not in _GROUP_CACHE:
            res = _analyze(run[0].instrs, ks, mask)
            if res is not None:
                deltas, reg_commit, last_commit = res
                group = VecGroup(run[0].instrs, np.asarray(ks, np.int64),
                                 mask, deltas, reg_commit, last_commit,
                                 ks[-1])
                group.plans = _build_plans(group.instrs, ks, mask)
            if len(_GROUP_CACHE) < _GROUP_CACHE_MAX:
                _GROUP_CACHE[key] = group      # None caches "unsafe" too
        if group is None:
            for p in run:
                items.extend(p.words)
        else:
            items.append(group)
        i = j
    return items


def compile_program(prog):
    """Compile a straight-line program into [SlotWord | VecGroup] items.
    Returns None if the program needs the scalar control-flow loop."""
    if any(w.lcu.op != "NOP" for w in prog):
        return None                            # loops/branches: scalar only
    items, packets = [], []

    def flush():
        nonlocal packets
        if packets:
            items.extend(_group_packets(packets))
            packets = []

    i, n = 0, len(prog)
    while i < n:
        w = prog[i]
        if w.lsu.op != "NOP" or w.mxcu.op != "SETK":
            flush()
            items.append(w)
            i += 1
            continue
        j = i + 1
        while (j < n and prog[j].lsu.op == "NOP"
               and prog[j].mxcu.op == "NOP"):
            j += 1
        p = _packet_for(prog[i:j], w.mxcu.k)
        if p is None:
            flush()
            items.extend(prog[i:j])
        else:
            packets.append(p)
        i = j
    flush()
    return items


def exec_group(col, g: VecGroup):
    """Run one VecGroup on a Column's state, committing the exact scalar
    end-state (VWR words, registers, last-results, k, counters)."""
    K = g.ks.shape[0]
    vwr = col.vwr
    regs = np.zeros((K, 4, 2), np.int64)
    last = np.zeros((K, 4), np.int64)
    srf = col.srf

    for plan in g.plans:
        if plan is None:
            continue
        op, pa, pb, dest, m = plan

        def gather(p):
            kind = p[0]
            if kind == "imm":
                return np.full((K, 4), p[1], np.int64)
            if kind == "reg":
                return regs[:, :, p[1]].copy()
            if kind == "srf":
                return np.full((K, 4), srf[p[1]], np.int64)
            if kind == "rc":
                return last[:, p[1]]
            if kind == "vwr":
                return vwr[p[1]][p[2]]
            # ("win", is_b, idx)
            _, is_b, idx = p
            return np.where(is_b, vwr["B"][idx], vwr["A"][idx])

        r = _alu_vec(op, gather(pa), gather(pb))
        if dest is not None:
            if dest[0] == "reg":
                regs[:, :, dest[1]][m] = r[m]
            else:
                vwr[dest[1]][dest[2]] = r[m]
        last[m] = r[m]

    for (rr, j), i in g.reg_commit:
        col.rc_regs[rr, j] = regs[i, rr, j]
    for rr, i in g.last_commit:
        col.rc_last[rr] = last[i, rr]
    col.k = g.final_k

    c = col.counters
    for name, v in g.deltas.items():
        setattr(c, name, getattr(c, name) + v)


def run_compiled(col, prog, items):
    """Execute a compiled straight-line program on one column."""
    col.pc = 0
    col.halted = not prog
    for item in items:
        if isinstance(item, VecGroup):
            exec_group(col, item)
        else:
            col.step(item)
    col.pc = len(prog)
    col.halted = True
