"""whisper-medium [arXiv:2212.04356] — encoder-decoder audio backbone.
24 encoder + 24 decoder layers; the conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d_model)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,          # decoder depth
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    rope_style="none",      # whisper uses absolute positions (sinusoidal here)
    norm_type="layernorm",
    mlp_gated=False,
    act="gelu",
    proj_bias=True,
    source="arXiv:2212.04356; hf:openai/whisper-medium",
))
