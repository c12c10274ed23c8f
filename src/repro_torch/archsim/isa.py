"""VWR2A slot ISA (paper §3.1-3.3, Table 1).

One configuration word per cycle per slot; bits == control signals (no
decode stage). We model each slot's instruction as a small dataclass; a
column executes one instruction per slot per cycle under a shared PC.

Slots per column: LCU (loops/branches), LSU (SPM<->VWR/SRF + shuffle unit),
MXCU (VWR word index k + masks), RC0..RC3 (32-bit ALU, 2-entry regfile).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---- operand sources / destinations for RC ops -----------------------------
# ("vwr", name[, off]) word (rc*32 + k + off) of the VWR (MXCU-controlled k;
#                      non-zero off models the paper's mux-network offset
#                      indexing via SRF masking values, §3.2)
# ("win", off)         virtual 256-word [B;A] window at 128 + rc*32 + k + off
#                      (boundary words for FIR/conv, §3.3.1)
# ("srf", i)           scalar register file entry i
# ("reg", 0|1)         RC-local register
# ("imm", value)       immediate
# ("rc", delta)        previous-cycle result of neighbour RC (delta = +-1)
# ("zero",)            constant 0

RC_OPS = ("NOP", "ADD", "SUB", "MUL", "FXMUL", "SLL", "SRL", "SRA",
          "AND", "OR", "XOR", "MAX", "MIN", "MOV")


@dataclasses.dataclass(frozen=True)
class RCInstr:
    op: str = "NOP"
    a: Tuple = ("zero",)
    b: Tuple = ("zero",)
    dest: Optional[Tuple] = None          # ("reg",i) | ("vwr",name) | ("srf",i)

    def __post_init__(self):
        assert self.op in RC_OPS, self.op


@dataclasses.dataclass(frozen=True)
class LSUInstr:
    op: str = "NOP"     # NOP | LOAD | STORE | LOAD_SRF | STORE_SRF | SHUFFLE
    vwr: str = "A"      # target VWR (LOAD/STORE) or shuffle half selector
    addr: Tuple = ("imm", 0)   # SPM line address source: ("imm",v)|("srf",i)
    shuffle_op: str = ""       # interleave|prune_even|prune_odd|bit_reverse|circular_shift
    half: str = "lower"


@dataclasses.dataclass(frozen=True)
class MXCUInstr:
    op: str = "NOP"     # NOP | SETK | INCK | ADDK
    k: int = 0          # immediate for SETK/ADDK


@dataclasses.dataclass(frozen=True)
class LCUInstr:
    op: str = "NOP"     # NOP | SETI | ADDI | BLT | BGE | JUMP | EXIT
    reg: int = 0        # LCU register index (4 regs)
    val: int = 0        # immediate / compare bound
    target: int = 0     # branch target PC


@dataclasses.dataclass(frozen=True)
class SlotWord:
    """One VLIW-style configuration word: all slots for one PC."""
    lcu: LCUInstr = LCUInstr()
    lsu: LSUInstr = LSUInstr()
    mxcu: MXCUInstr = MXCUInstr()
    rcs: Tuple[RCInstr, RCInstr, RCInstr, RCInstr] = (
        RCInstr(), RCInstr(), RCInstr(), RCInstr())


NOP_WORD = SlotWord()
NOP_RC = RCInstr()


# ---- k-sweep macro ---------------------------------------------------------
# Generated kernel programs are dominated by "k-sweeps": the same per-RC
# instruction sequence replayed at a series of MXCU word indices k (a SETK
# configuration word followed by mxcu-NOP body words).  sweep_words() is the
# one builder all program generators share.  It memoizes the SlotWords per
# (instruction sequence, k, lane mask): the body words of a sweep do not
# depend on k at all, so every k (and every later pass/block reusing the
# pattern) gets the *same* word objects back.  That identity-sharing is what
# lets the vectorized engine (vector.py) recognize and cache repeated
# packets instead of re-analyzing tens of thousands of fresh dataclasses.

_SWEEP_CACHE: dict = {}
_ALL_LANES = (True, True, True, True)


def sweep_words(k: int, instrs, active=_ALL_LANES) -> list:
    """One sweep instance: SETK k, then `instrs` issued per cycle on the
    lanes enabled in `active` (inactive RCs issue NOPs; their cycles are
    still charged).  `instrs` must be a hashable tuple of RCInstr."""
    instrs = tuple(instrs)
    active = tuple(active)
    key = (instrs, active)
    body = _SWEEP_CACHE.get(key)
    if body is None:
        rcs_rows = [tuple(ins if active[r] else NOP_RC for r in range(4))
                    for ins in instrs]
        body = [SlotWord(rcs=rcs) for rcs in rcs_rows[1:]]
        _SWEEP_CACHE[key] = body
        _SWEEP_CACHE[key + ("heads",)] = {}
    heads = _SWEEP_CACHE[key + ("heads",)]
    head = heads.get(k)
    if head is None:
        rcs0 = tuple(instrs[0] if active[r] else NOP_RC for r in range(4))
        head = SlotWord(mxcu=MXCUInstr("SETK", k), rcs=rcs0)
        heads[k] = head
    return [head] + body
