"""Architecture / shape configuration and registry (the port's own copy of
the JAX package's `configs/base.py`).

Every assigned architecture has one module in this package defining a
``CONFIG = ArchConfig(...)`` with the published dimensions, registered
under its id. The dtypes are torch dtypes: parameters in float32, compute
in bfloat16 by default, as in the reference. ``input_specs`` gives one
(arch x shape) cell's abstract inputs as "meta" tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "ShapeSpec", "SHAPES",
           "applicable_shapes", "get_config", "input_specs", "list_configs",
           "reduced", "register", "smoke_shape"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int = 0
    every_k_layers: int = 1       # MoE on layers where (i % every_k) == every_k-1
    first_dense: int = 0          # first N layers are dense
    capacity_factor: float = 1.25
    group_size: int = 128         # GShard dispatch group size (tokens)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                     # "rwkv6" | "mamba2"
    head_size: int = 64           # rwkv6 head size / mamba2 headdim
    d_state: int = 64             # mamba2 SSM state size
    expand: int = 2               # mamba2 d_inner = expand * d_model
    conv_kernel: int = 4          # mamba2 short conv
    chunk_size: int = 64          # chunked-scan block length
    lora_rank: int = 64           # rwkv6 data-dependent mix LoRA rank
    impl: str = "stable"          # wkv evaluator: stable | matmul
    wkv_clamp: float = -2.0       # per-step log-decay floor (matmul impl)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    # attention flavour
    rope_style: str = "neox"      # neox | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (2, 1, 1)   # fractions (of head_dim/2) per t/h/w stream
    qkv_bias: bool = False
    proj_bias: bool = False
    sliding_window: Optional[int] = None
    # block flavour
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    mlp_gated: bool = True
    act: str = "silu"
    tie_embeddings: bool = False
    # families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0    # zamba2: shared attention block period
    encoder_layers: int = 0       # whisper: encoder depth (num_layers = decoder depth)
    enc_ctx: int = 1500           # enc-dec: encoder frames (whisper: 30 s)
    vlm_patches: int = 0          # qwen2-vl: patch embeddings per sample (stub frontend)
    # numerics / training
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # attention chunking (flash-style blockwise attention)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # pad query heads (per KV group) so the head axis divides the TP degree;
    # padded heads are masked out (exactly-zero output)
    tp_pad: int = 16
    remat: str = "dots"           # none | dots | full (training only)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def attention_free(self) -> bool:
        return self.ssm is not None and self.shared_attn_every == 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context? (SSM/hybrid/SWA)"""
        return self.ssm is not None or self.sliding_window is not None

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _  # registry population  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _  # noqa: F401

    return sorted(_REGISTRY)


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The assigned shape cells that are well-defined for this arch:
    long_500k only for sub-quadratic (SSM, hybrid, sliding-window) archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Abstract model inputs for one (arch x shape) cell, as tensors on
    the "meta" device (shapes and dtypes, no storage).

    train  : the full batch with labels;
    prefill: the full batch, no labels;
    decode : one new token a sequence and a 0-d ``cache_len`` (the cache
             is `models.api.abstract_cache`'s).
    Whisper adds its encoder frames (a fixed ``enc_ctx``), qwen2-vl its
    patch embeddings and t/h/w positions."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def f(*s):
        return torch.empty(s, dtype=torch.int32, device=meta)

    def e(*s):
        return torch.empty(s, dtype=cfg.compute_dtype, device=meta)

    if shape.kind == "train":
        batch = {"tokens": f(B, S), "labels": f(B, S)}
    elif shape.kind == "prefill":
        batch = {"tokens": f(B, S)}
    else:
        batch = {"tokens": f(B, 1), "cache_len": f()}
    if cfg.is_encdec and shape.kind in ("train", "prefill"):
        batch["frames"] = e(B, cfg.enc_ctx, cfg.d_model)
    if cfg.vlm_patches:
        if shape.kind in ("train", "prefill"):
            batch["patch_emb"] = e(B, cfg.vlm_patches, cfg.d_model)
            batch["positions"] = f(B, S, 3)
        else:
            batch["positions"] = f(B, 1, 3)
    return batch


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family config: a few layers, tiny widths, tiny vocab,
    float32 compute."""
    kw: dict[str, Any] = dict(
        name=cfg.name + "-smoke",
        num_layers=4 if cfg.shared_attn_every else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        q_chunk=32,
        kv_chunk=32,
        tp_pad=1,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            d_ff_shared=32 if cfg.moe.num_shared else 0, group_size=16,
            first_dense=min(cfg.moe.first_dense, 1),
        )
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, head_size=8, d_state=8, chunk_size=8, lora_rank=8
        )
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 2
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["enc_ctx"] = 16
    if cfg.vlm_patches:
        kw["vlm_patches"] = 4
    if cfg.sliding_window:
        kw["sliding_window"] = 48
    return dataclasses.replace(cfg, **kw)


def smoke_shape(kind: str = "train") -> ShapeSpec:
    if kind == "train":
        return ShapeSpec("smoke_train", 64, 2, "train")
    if kind == "prefill":
        return ShapeSpec("smoke_prefill", 64, 2, "prefill")
    return ShapeSpec("smoke_decode", 64, 2, "decode")
