"""llama4-maverick-400b-a17b [hf:meta-llama; unverified] — MoE 128 routed
experts top-1 + 1 shared expert, MoE every 2nd layer (interleave), expert/shared/dense d_ff=8192 (assigned). This realizes the
published ~400B-total / ~17B-active shape with the assigned dims; the derived
interleave is documented in DESIGN.md. Early fusion is a frontend concern;
per the brief this entry is the text backbone."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,             # dense (non-MoE) layers, per assignment
    vocab_size=202048,
    head_dim=128,
    rope_theta=500000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared=1,
        d_ff_shared=8192,
        every_k_layers=2,
        capacity_factor=1.25,
        group_size=128,
    ),
    source="hf:meta-llama/Llama-4-Maverick-17B-128E (dims per assignment)",
))
