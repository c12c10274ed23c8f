"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B] — QKV bias, tied embeddings."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    rope_theta=1000000.0,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
))
