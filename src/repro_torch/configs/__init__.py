"""Configurations the port serves (own copies of the reference's):
importing this package registers every assigned architecture, as the
JAX package's `configs/__init__.py` does."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    SHAPES,
    applicable_shapes,
    get_config,
    input_specs,
    list_configs,
    reduced,
    register,
    smoke_shape,
)

# one module per assigned architecture (registration side effect)
from repro_torch.configs import (  # noqa: F401
    deepseek_coder_33b,
    starcoder2_7b,
    qwen1_5_0_5b,
    h2o_danube3_4b,
    rwkv6_7b,
    whisper_medium,
    qwen2_vl_2b,
    llama4_maverick,
    deepseek_moe_16b,
    zamba2_7b,
    vwr2a_biosignal,
)

ASSIGNED = [
    "deepseek-coder-33b",
    "starcoder2-7b",
    "qwen1.5-0.5b",
    "h2o-danube-3-4b",
    "rwkv6-7b",
    "whisper-medium",
    "qwen2-vl-2b",
    "llama4-maverick-400b-a17b",
    "deepseek-moe-16b",
    "zamba2-7b",
]
