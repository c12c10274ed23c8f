"""Model layers of the port: every family's layers (`layers`,
`attention`, `moe`, `rwkv`, `mamba`, assembled by `transformer`) behind
`api`'s ``build_model``, and the O(S^2) attention oracle that the
flash-attention kernel is held to."""
from repro_torch.models.api import (  # noqa: F401
    Model,
    build_model,
    cast_params,
    init_cast_params,
    init_cache,
    init_model_params,
    params_from_numpy,
)
