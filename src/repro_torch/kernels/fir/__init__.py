"""The standalone causal FIR: its CUDA kernel and plain version
(`kernel`, source in `csrc/`), the public entry (`ops`) and the oracles
(`ref`)."""
