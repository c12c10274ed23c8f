"""zamba2-7b [arXiv:2411.15242; unverified] — hybrid: Mamba2 backbone with a
SHARED full-attention block applied periodically. 81 Mamba2 layers,
d_model 3584, ssm_state 64, shared attn 32H (MHA) + MLP d_ff 14336 every 6
layers (simplified from Zamba2's two alternating shared blocks; documented
in DESIGN.md)."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    rope_theta=10000.0,
    ssm=SSMConfig(kind="mamba2", head_size=64, d_state=64, expand=2,
                  conv_kernel=4, chunk_size=64),
    shared_attn_every=6,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-7B",
))
