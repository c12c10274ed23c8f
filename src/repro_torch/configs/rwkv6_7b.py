"""rwkv6-7b (Finch) [arXiv:2404.05892; hf] — attention-free, data-dependent
decay. head_size 64 => 64 heads at d_model 4096. channel-mix d_ff = 14336."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # wkv heads = d_model / head_size
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    rope_style="none",
    norm_type="layernorm",
    ssm=SSMConfig(kind="rwkv6", head_size=64, chunk_size=64, lora_rank=64),
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b",
))
