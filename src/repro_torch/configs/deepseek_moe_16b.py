"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained experts:
2 shared + 64 routed top-6, expert d_ff=1408, first layer dense (d_ff=10944
in HF; we use 4*2048*1.34~10944). 28 layers, d_model 2048."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,            # the single dense layer
    vocab_size=102400,
    head_dim=128,
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared=2,
        d_ff_shared=1408,
        every_k_layers=1,
        first_dense=1,
        capacity_factor=1.25,
        group_size=128,
    ),
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
))
