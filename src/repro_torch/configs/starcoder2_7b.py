"""starcoder2-7b [arXiv:2402.19173; hf] — GQA, RoPE, non-gated GELU MLP,
layernorm, biased projections (HF config: use_bias=true, mlp 4x)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    rope_theta=1000000.0,
    qkv_bias=True,
    proj_bias=True,
    norm_type="layernorm",
    mlp_gated=False,
    act="gelu",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
))
