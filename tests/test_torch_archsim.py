"""The port's cycle-accurate simulator (`repro_torch.archsim`) against the
JAX package's (`repro.archsim`), on the same inputs.

Every case of `tests/test_archsim.py` (machine semantics, kernel
numerics, the paper's Table 2/4 cycle agreement, the energy model's
calibration) and `tests/test_archsim_vector.py` (the vector engine
against the scalar one, the column scaling) runs in both packages. The
simulator is numpy on the host in both, so everything must be identical:
SPM and SRF contents, VWRs, RC registers, every `Counters` field, cycles,
outputs and `vwr2a_energy_uj`. The reference cases' own properties (the
paper's cycle ranges, the numerics against numpy) are asserted on the
port's side.
"""
import dataclasses

import numpy as np
import pytest

import repro.archsim.energy as j_energy
import repro.archsim.isa as j_isa
import repro.archsim.machine as j_machine
import repro.archsim.programs.app as j_app
import repro.archsim.programs.fft as j_fft
import repro.archsim.programs.fir as j_fir
import repro_torch.archsim.energy as t_energy
import repro_torch.archsim.isa as t_isa
import repro_torch.archsim.machine as t_machine
import repro_torch.archsim.programs.app as t_app
import repro_torch.archsim.programs.fft as t_fft
import repro_torch.archsim.programs.fir as t_fir
from repro_torch.core.fir import lowpass_taps

PKGS = {"ref": (j_isa, j_machine, j_fft, j_fir, j_app, j_energy),
        "port": (t_isa, t_machine, t_fft, t_fir, t_app, t_energy)}
RC_SLICE = t_machine.RC_SLICE


def _rng(seed=0):
    return np.random.default_rng(seed)


def fir_reference(x, taps):
    """np.convolve truncated to causal, as the reference's oracle."""
    x = np.asarray(x, np.float64)
    return np.convolve(x, np.asarray(taps, np.float64))[: x.shape[0]]


def assert_machines_identical(ma, mb):
    np.testing.assert_array_equal(ma.spm, mb.spm)
    np.testing.assert_array_equal(ma.srf, mb.srf)
    assert ma.n_columns == mb.n_columns
    for ca, cb in zip(ma.cols, mb.cols):
        assert dataclasses.asdict(ca.counters) == dataclasses.asdict(
            cb.counters)
        for n in "ABC":
            np.testing.assert_array_equal(ca.vwr[n], cb.vwr[n])
        np.testing.assert_array_equal(ca.rc_regs, cb.rc_regs)
        np.testing.assert_array_equal(ca.rc_last, cb.rc_last)
        assert ca.k == cb.k


def assert_results_identical(a, b):
    """Two program results (tuples of arrays, Counters and ints)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        elif dataclasses.is_dataclass(x):
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
        else:
            assert x == y


def _both(fn):
    """Run ``fn(isa, machine, fft, fir, app, energy)`` in both packages."""
    return fn(*PKGS["ref"]), fn(*PKGS["port"])


# ---------------------------------------------------------------- machine

def test_q15_roundtrip():
    vals = (0.0, 0.5, -0.99, 0.123, 1.5, -7.25)
    for v in vals:
        assert j_machine.to_q15(v) == t_machine.to_q15(v)
        assert j_machine.from_q15(j_machine.to_q15(v)) == \
            t_machine.from_q15(t_machine.to_q15(v))
    for v in vals[:4]:
        assert abs(t_machine.from_q15(t_machine.to_q15(v)) - v) < 2 ** -14
    x = _rng().normal(size=300)
    np.testing.assert_array_equal(j_machine.to_q15_arr(x),
                                  t_machine.to_q15_arr(x))
    for total, parts in ((0, 3), (7, 2), (129, 4), (5, 8)):
        assert j_machine.split_work(total, parts) == \
            t_machine.split_work(total, parts)


def _vector_add(isa, machine, *_):
    m = machine.VWR2A()
    a = np.arange(128, dtype=np.int64)
    m.spm[0], m.spm[1] = a, a * 2
    prog = [isa.SlotWord(lsu=isa.LSUInstr("LOAD", "A", ("imm", 0))),
            isa.SlotWord(lsu=isa.LSUInstr("LOAD", "B", ("imm", 1)))]
    ins = isa.RCInstr("ADD", ("vwr", "A"), ("vwr", "B"), ("vwr", "C"))
    for k in range(RC_SLICE):
        prog.append(isa.SlotWord(mxcu=isa.MXCUInstr("SETK", k),
                                 rcs=(ins, ins, ins, ins)))
    prog.append(isa.SlotWord(lsu=isa.LSUInstr("STORE", "C", ("imm", 2))))
    m.run([prog, []])
    return m, len(prog)


def _fxmul(isa, machine, *_):
    m = machine.VWR2A()
    m.spm[0, :] = machine.to_q15(0.5)
    m.spm[1, :] = machine.to_q15(-0.25)
    prog = [isa.SlotWord(lsu=isa.LSUInstr("LOAD", "A", ("imm", 0))),
            isa.SlotWord(lsu=isa.LSUInstr("LOAD", "B", ("imm", 1))),
            isa.SlotWord(mxcu=isa.MXCUInstr("SETK", 0),
                         rcs=tuple(isa.RCInstr("FXMUL", ("vwr", "A"),
                                               ("vwr", "B"), ("vwr", "C"))
                                   for _ in range(4)))]
    m.run([prog, []])
    return m, None


def _lcu_loop(isa, machine, *_):
    m = machine.VWR2A()
    body = isa.SlotWord(lcu=isa.LCUInstr("ADDI", reg=0, val=1),
                        rcs=(isa.RCInstr("ADD", ("reg", 0), ("imm", 1),
                                         ("reg", 0)),
                             isa.RCInstr(), isa.RCInstr(), isa.RCInstr()))
    prog = [isa.SlotWord(lcu=isa.LCUInstr("SETI", reg=0, val=0)),
            body,
            isa.SlotWord(lcu=isa.LCUInstr("BLT", reg=0, val=10, target=1)),
            isa.SlotWord(lcu=isa.LCUInstr("EXIT"))]
    m.run([prog, []])
    return m, None


@pytest.mark.parametrize("case", [_vector_add, _fxmul, _lcu_loop],
                         ids=["vector_add", "fxmul_q15", "lcu_loop"])
def test_machine_programs_identical(case):
    """`test_machine_vector_add`, `test_machine_fxmul_q15`,
    `test_machine_lcu_loop`: the same hand-built program leaves the same
    machine in both packages."""
    (jm, jn), (tm, tn) = _both(case)
    assert_machines_identical(jm, tm)
    if case is _vector_add:
        np.testing.assert_array_equal(tm.spm[2], np.arange(128) * 3)
        assert tm.cols[0].counters.cycles == tn
    elif case is _fxmul:
        got = t_machine.from_q15(tm.cols[0].vwr["C"][0])
        assert abs(got - (-0.125)) < 2 ** -14
    else:
        assert int(tm.cols[0].rc_regs[0, 0]) == 10


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("n", [64, 256, 512])
def test_sim_fft_identical(n):
    """`test_sim_fft_numerics`: the simulated FFT, its counters and cycles
    are the reference's; the numerics hold against numpy."""
    x = (_rng(n).normal(size=n) + 1j * _rng(n + 1).normal(size=n)) * 0.3
    j, t = _both(lambda *p: p[2].run_fft(n, x))
    assert_results_identical(j, t)
    ref = np.fft.fft(x)
    assert np.abs(t[0] - ref).max() / np.abs(ref).max() < 0.01


def test_sim_fft_cycles_track_paper():
    """Table 2: the same order and N log N scaling, identical cycles."""
    paper = {512: 7125, 1024: 12405, 2048: 30217}
    rng = np.random.default_rng(0)
    for n, p in paper.items():
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.3
        j, t = _both(lambda *pk: pk[2].run_fft(n, x))
        assert_results_identical(j, t)
        assert 0.5 < t[2] / p < 1.1, (n, t[2], p)


def test_sim_rfft_identical():
    x = _rng(3).normal(size=512) * 0.3
    j, t = _both(lambda *p: p[2].run_rfft(512, x))
    assert_results_identical(j, t)
    ref = np.fft.rfft(x)
    assert np.abs(t[0] - ref).max() / np.abs(ref).max() < 0.01
    assert 0.5 < t[2] / 3666 < 1.1      # paper Table 2 real-valued 512


def test_sim_fir_identical():
    taps = lowpass_taps(11)
    x = np.sin(np.arange(512) * 0.1) * 0.5
    j, t = _both(lambda *p: p[3].run_fir(x, taps))
    assert_results_identical(j, t)
    assert np.abs(t[0] - fir_reference(x, taps)).max() < 1e-3
    assert t[2] < 3260                  # paper Table 4 (denser mapping)
    assert t[1].dma_words == 1024       # 512 in + 512 out


def test_energy_calibration_identical():
    """The Table-3 calibration closes in the port as in the reference,
    to the same model."""
    jm, tm = j_energy.default_model(), t_energy.default_model()
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    _, counters, cycles = t_fft.run_rfft(512, _rng(0).normal(size=512) * 0.3)
    e = tm.energy_pj(counters)
    assert e == jm.energy_pj(counters)
    assert abs(e["memories"] / e["total"] - 0.64) < 0.03
    assert abs(e["datapath"] / e["total"] - 0.32) < 0.03
    total_mw = e["total"] * 1e-12 / (cycles / 80e6) * 1e3
    assert abs(total_mw - 5.41) < 0.1
    assert j_energy.cpu_energy_uj(166667) == t_energy.cpu_energy_uj(166667)


def test_energy_scales_with_work():
    taps = lowpass_taps(11)
    e = []
    for n in (256, 512, 1024):
        x = np.sin(np.arange(n) * 0.1) * 0.5
        (_, jc, _), (_, tc, _) = _both(lambda *p: p[3].run_fir(x, taps))
        e.append(t_energy.vwr2a_energy_uj(tc))
        assert e[-1] == j_energy.vwr2a_energy_uj(jc)
    assert e[0] < e[1] < e[2]
    assert abs(e[2] / e[0] - 4.0) < 0.5     # ~linear in N


# --------------------------------------------------- engines and columns

def _engines(kind, run):
    """``run(machine_module, machine, programs_module...)`` on a fresh
    machine of ``kind`` in each package; returns both (result, machine)."""
    def go(isa, machine, fft, fir, app, energy):
        m = machine.VWR2A(engine=kind)
        return run(m, isa, machine, fft, fir, app), m
    return _both(go)


def _fft64(m, isa, machine, fft, fir, app):
    x = (_rng(64).normal(size=64) + 1j * _rng(65).normal(size=64)) * 0.3
    return fft.run_fft(64, x, machine=m)


def _fft256(m, isa, machine, fft, fir, app):
    x = (_rng(256).normal(size=256) + 1j * _rng(257).normal(size=256)) * 0.3
    return fft.run_fft(256, x, machine=m)


def _rfft512(m, isa, machine, fft, fir, app):
    return fft.run_rfft(512, _rng(7).normal(size=512) * 0.3, machine=m)


def _fir512(m, isa, machine, fft, fir, app):
    return fir.run_fir(np.sin(np.arange(512) * 0.1) * 0.5, lowpass_taps(11),
                       machine=m)


def _delineate256(m, isa, machine, fft, fir, app):
    return app.run_delineate(_rng(9).normal(size=256) * 0.2, machine=m)


def _raw_sweep(m, isa, machine, fft, fir, app):
    a = np.arange(128, dtype=np.int64) - 64
    m.spm[0], m.spm[1] = a, np.arange(128, dtype=np.int64) * 3
    prog = [isa.SlotWord(lsu=isa.LSUInstr("LOAD", "A", ("imm", 0))),
            isa.SlotWord(lsu=isa.LSUInstr("LOAD", "B", ("imm", 1)))]
    ins0 = isa.RCInstr("SUB", ("vwr", "A"), ("vwr", "B"), ("reg", 0))
    ins1 = isa.RCInstr("MUL", ("reg", 0), ("rc", 0), ("vwr", "C"))
    for k in range(RC_SLICE):
        prog.append(isa.SlotWord(mxcu=isa.MXCUInstr("SETK", k),
                                 rcs=(ins0, ins0, ins0, ins0)))
        prog.append(isa.SlotWord(rcs=(ins1, ins1, ins1, ins1)))
    prog.append(isa.SlotWord(lsu=isa.LSUInstr("STORE", "C", ("imm", 2))))
    m.run([prog])
    return ()


def _branchy(m, isa, machine, fft, fir, app):
    body = isa.SlotWord(lcu=isa.LCUInstr("ADDI", reg=0, val=1),
                        rcs=(isa.RCInstr("ADD", ("reg", 0), ("imm", 3),
                                         ("reg", 0)),
                             isa.RCInstr(), isa.RCInstr(), isa.RCInstr()))
    prog = [isa.SlotWord(lcu=isa.LCUInstr("SETI", reg=0, val=0)), body,
            isa.SlotWord(lcu=isa.LCUInstr("BLT", reg=0, val=7, target=1)),
            isa.SlotWord(lcu=isa.LCUInstr("EXIT"))]
    m.run([prog])
    return ()


def _unprovable_dest(m, isa, machine, fft, fir, app):
    m.spm[0] = np.arange(128)
    prog = [isa.SlotWord(lsu=isa.LSUInstr("LOAD", "A", ("imm", 0)))]
    ins = isa.RCInstr("ADD", ("vwr", "A"), ("imm", 1), ("win", 0))
    for k in range(RC_SLICE):
        prog.append(isa.SlotWord(mxcu=isa.MXCUInstr("SETK", k),
                                 rcs=(ins, ins, ins, ins)))
    m.run([prog])
    return ()


ENGINE_CASES = {"fft64": _fft64, "fft256": _fft256, "rfft512": _rfft512,
                "fir512": _fir512, "delineate256": _delineate256,
                "raw_sweep": _raw_sweep, "branchy": _branchy,
                "unprovable_dest": _unprovable_dest}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engines_identical_across_packages(case):
    """`tests/test_archsim_vector.py`'s engine cases (FFT 64/256, rFFT,
    FIR, delineation, the raw k-sweep, the branchy program and the
    unprovable destination, both of which fall back to the scalar path):
    each engine of the port equals the same engine of the reference, and
    the port's vector engine equals its scalar one, result and machine
    state alike."""
    run = ENGINE_CASES[case]
    (js, jms), (ts, tms) = _engines("scalar", run)
    (jv, jmv), (tv, tmv) = _engines("vector", run)
    for a, b, ma, mb in ((js, ts, jms, tms), (jv, tv, jmv, tmv),
                         (ts, tv, tms, tmv)):
        assert_results_identical(a, b)
        assert_machines_identical(ma, mb)
    if case == "raw_sweep":
        np.testing.assert_array_equal(
            tmv.spm[2], (np.arange(128) - 64 - np.arange(128) * 3) ** 2)
    if case == "branchy":
        assert int(tmv.cols[0].rc_regs[0, 0]) == 21


@pytest.mark.parametrize("n_columns", [1, 2, 4])
def test_multicolumn_identical(n_columns):
    """`test_fft_multicolumn_numerics`, `test_fir_multicolumn_numerics`:
    any column count gives the reference's results, counters and cycles."""
    x = (_rng(1).normal(size=256) + 1j * _rng(2).normal(size=256)) * 0.3
    j, t = _both(lambda *p: p[2].run_fft(256, x, n_columns=n_columns))
    assert_results_identical(j, t)
    ref = np.fft.fft(x)
    assert np.abs(t[0] - ref).max() / np.abs(ref).max() < 0.01
    taps = lowpass_taps(11)
    xs = np.sin(np.arange(512) * 0.1) * 0.5
    j, t = _both(lambda *p: p[3].run_fir(xs, taps, n_columns=n_columns))
    assert_results_identical(j, t)
    assert np.abs(t[0] - fir_reference(xs, taps)).max() < 1e-3
    assert t[1].dma_words == 1024


def test_multicolumn_cycle_scaling():
    """`test_fft_multicolumn_cycle_scaling`,
    `test_fir_multicolumn_cycle_scaling`: wall cycles fall with the
    column count while total activity is conserved, as in the
    reference."""
    x = (_rng(1).normal(size=256) + 1j * _rng(2).normal(size=256)) * 0.3
    runs = [t_fft.run_fft(256, x, n_columns=nc) for nc in (1, 2, 4)]
    refs = [j_fft.run_fft(256, x, n_columns=nc) for nc in (1, 2, 4)]
    assert [r[2] for r in runs] == [r[2] for r in refs]
    assert runs[0][2] > runs[1][2] > runs[2][2]
    assert runs[0][1].rc_ops == runs[1][1].rc_ops == runs[2][1].rc_ops
    taps = lowpass_taps(11)
    xs = np.sin(np.arange(512) * 0.1) * 0.5
    cycles = [t_fir.run_fir(xs, taps, n_columns=nc)[2] for nc in (1, 2, 4)]
    assert cycles == [j_fir.run_fir(xs, taps, n_columns=nc)[2]
                      for nc in (1, 2, 4)]
    assert cycles[0] > cycles[1] > cycles[2]
    assert cycles[0] >= 2 * cycles[1]


@pytest.mark.parametrize("n_columns", [1, 2, 3, 4, 5])
def test_rfft_activity_conserved_any_width(n_columns):
    """Host-side cycle charges conserve total activity for ANY column
    count, and every counter equals the reference's."""
    x = _rng(5).normal(size=512) * 0.3
    _, ref, _ = t_fft.run_rfft(512, x, n_columns=2)
    j, t = _both(lambda *p: p[2].run_rfft(512, x, n_columns=n_columns))
    assert_results_identical(j, t)
    for f in ("rc_ops", "rc_mults", "vwr_reads", "vwr_writes",
              "spm_line_reads", "spm_line_writes"):
        assert getattr(t[1], f) == getattr(ref, f), f


@pytest.mark.parametrize("engine", ["vector", "scalar"])
def test_run_app_identical(engine):
    """The whole MBioTracker window on the simulator (`run_app`, what the
    app's cycle and energy line reads): every stage's counters and
    cycles, the prediction and the energy equal the reference's."""
    from repro_torch.core.biosignal import synthetic_respiration

    sig = synthetic_respiration(1, 2048, seed=3, device="cpu")[0][0].numpy()
    w = _rng(4).normal(size=(12, 2)).astype(np.float32)
    b = np.asarray([0.1, -0.2], np.float32)
    taps = lowpass_taps(11)
    j = j_app.run_app(sig * 0.5, taps, w, b, engine=engine)
    t = t_app.run_app(sig * 0.5, taps, w, b, engine=engine)
    assert sorted(j) == sorted(t)
    assert j["prediction"] == t["prediction"]
    for k in ("preprocessing", "delineation", "feat_extraction", "svm"):
        assert dataclasses.asdict(j[k][0]) == dataclasses.asdict(t[k][0])
        assert j[k][1] == t[k][1]
        assert j_energy.vwr2a_energy_uj(j[k][0]) == \
            t_energy.vwr2a_energy_uj(t[k][0])
