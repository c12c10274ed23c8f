"""Rotary position embedding as a standalone kernel: its CUDA kernel and
plain version (`kernel`, source in `csrc/`), the public entry (`ops`) and
the float64-table oracle (`ref`)."""
