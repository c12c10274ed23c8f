"""h2o-danube-3-4b [arXiv:2401.16818; unverified] — llama+mistral mix with
sliding-window attention. Window size is not pinned in the assignment; we use
4096 (mistral-style) and document the assumption in DESIGN.md."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    rope_theta=10000.0,
    sliding_window=4096,
    source="arXiv:2401.16818 (danube family); window=4096 assumed",
))
