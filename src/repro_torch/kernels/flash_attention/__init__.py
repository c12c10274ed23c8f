"""Flash attention as a standalone kernel: its CUDA kernel and plain
version (`kernel`, source in `csrc/`), the public entry (`ops`) and the
O(S^2) oracle (`ref`)."""
