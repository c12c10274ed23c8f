"""qwen2-vl-2b [arXiv:2409.12191; hf] — M-RoPE (3D t/h/w rotary streams),
dynamic-resolution vision. The vision tower is a STUB: input_specs()
provides precomputed patch embeddings + (B,S,3) positions. mrope_sections
(2,1,1) splits head_dim/2 rotary freqs between t/h/w like the HF config
(16,24,24 of 64 ~ coarse 2:1:1 split at our granularity)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    rope_style="mrope",
    rope_theta=1000000.0,
    mrope_sections=(2, 1, 1),
    qkv_bias=True,
    vlm_patches=256,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B",
))
