"""Cycle-accurate VWR2A simulator + Table-3-calibrated energy model.

machine.py — N columns x (4 RCs + LSU + MXCU + LCU), 3x128-word VWRs,
32 KiB SPM, SRF, shuffle unit, q16.15 datapath (paper Fig. 1 is the
2-column default). vector.py — the NumPy-vectorized interpreter
(bit-exact vs the scalar reference path, incl. activity counters).
programs/ — generated kernel mappings (FFT §3.4, FIR §4.4.1,
MBioTracker app §4.4.2), parameterized over the column count.
"""
from repro_torch.archsim import energy, isa, machine, vector  # noqa: F401
