"""Generated kernel mappings for the simulator: the FFT (§3.4), the FIR
(§4.4.1) and the MBioTracker application (§4.4.2)."""
