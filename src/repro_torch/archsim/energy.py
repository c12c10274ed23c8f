"""Activity-based energy model calibrated to the paper's Table 3.

Table 3 gives the VWR2A power breakdown at 80 MHz while executing a
512-point real-valued FFT: DMA 0.0947 mW (2%), Memories 3.49 mW (64%, of
which SPM 46% / VWRs 54%), Control 0.100 mW (2%), Datapath 1.72 mW (32%),
total 5.41 mW. We calibrate per-event energies so that OUR simulated
512-pt rFFT activity reproduces exactly that breakdown; Tables 4/5 energies
are then predictions from activity counts. CPU energy uses the paper's own
Table 4 rate (0.37 uJ / 24747 cycles ~ 15 pJ/cycle).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.archsim.machine import Counters

F_HZ = 80e6
# Table 3 (VWR2A column), in mW
P_DMA = 9.47e-2
P_MEM = 3.49
P_SPM = P_MEM * 0.46
P_VWR = P_MEM * 0.54
P_CTRL = 1.00e-1
P_DP = 1.72
P_TOTAL = 5.41

# paper Table 4: CPU (Cortex-M4 + CMSIS q15): 0.37 uJ / 24747 cycles
CPU_PJ_PER_CYCLE = 0.37e-6 / 24747 * 1e12       # ~14.95 pJ/cycle
# paper Table 2+Fig 2 context: FFT ACCEL ~0.983 mW at 80 MHz
FFT_ACCEL_PJ_PER_CYCLE = 0.983e-3 / F_HZ * 1e12  # ~12.3 pJ/cycle


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    pj_spm_line: float
    pj_vwr_access: float
    pj_rc_op: float
    pj_ctrl_cycle: float
    pj_dma_word: float

    def energy_pj(self, c: Counters) -> dict:
        spm = (c.spm_line_reads + c.spm_line_writes) * self.pj_spm_line
        vwr = (c.vwr_reads + c.vwr_writes) * self.pj_vwr_access
        dp = c.rc_ops * self.pj_rc_op
        ctrl = c.cycles * self.pj_ctrl_cycle
        dma = c.dma_words * self.pj_dma_word
        total = spm + vwr + dp + ctrl + dma
        return {"spm": spm, "vwr": vwr, "datapath": dp, "control": ctrl,
                "dma": dma, "memories": spm + vwr, "total": total}


def calibrate(counters: Counters, wall_cycles: int) -> EnergyModel:
    """Fit per-event energies so this activity profile reproduces the
    Table 3 powers at 80 MHz."""
    t_s = wall_cycles / F_HZ
    mw_to_pj = lambda p_mw: p_mw * 1e-3 * t_s * 1e12  # component energy in pJ
    spm_ev = max(1, counters.spm_line_reads + counters.spm_line_writes)
    vwr_ev = max(1, counters.vwr_reads + counters.vwr_writes)
    rc_ev = max(1, counters.rc_ops)
    dma_ev = max(1, counters.dma_words)
    return EnergyModel(
        pj_spm_line=mw_to_pj(P_SPM) / spm_ev,
        pj_vwr_access=mw_to_pj(P_VWR) / vwr_ev,
        pj_rc_op=mw_to_pj(P_DP) / rc_ev,
        pj_ctrl_cycle=mw_to_pj(P_CTRL) / max(1, counters.cycles),
        pj_dma_word=mw_to_pj(P_DMA) / dma_ev,
    )


_DEFAULT: EnergyModel | None = None


def default_model() -> EnergyModel:
    """Calibrated on the simulated 512-pt real FFT (lazy singleton)."""
    global _DEFAULT
    if _DEFAULT is None:
        from repro_torch.archsim.programs.fft import run_rfft

        rng = np.random.default_rng(0)
        _, counters, cycles = run_rfft(512, rng.normal(size=512) * 0.3)
        _DEFAULT = calibrate(counters, cycles)
    return _DEFAULT


def cpu_energy_uj(cycles: int) -> float:
    return cycles * CPU_PJ_PER_CYCLE * 1e-6


def vwr2a_energy_uj(c: Counters) -> float:
    return default_model().energy_pj(c)["total"] * 1e-6
