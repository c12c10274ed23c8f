"""The standalone batched FFT: its CUDA kernel and plain version
(`kernel`, source in `csrc/`), the public entries (`ops`) and the
oracles (`ref`)."""
