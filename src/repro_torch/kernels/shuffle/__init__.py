"""The VWR2A shuffle unit as a standalone kernel: its CUDA kernel and plain
version (`kernel`, source in `csrc/`), the public entry (`ops`) and the
oracle (`ref`)."""
