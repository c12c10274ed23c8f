"""AdamW with dtype-configurable state (the port's counterpart of the JAX
package's `train/optim.py`).

  * the first moment storable in bfloat16, the second in block-scaled
    int8 (``"qint8"``: one float32 scale per block of the last axis), the
    reduced-memory state a large MoE needs;
  * global-norm clipping, linear warmup + cosine schedule, decoupled
    weight decay on matrices only (leaves of rank 2 or more).

Where the reference returns new trees, `adamw_update` updates the
parameters and the state IN PLACE under `torch.no_grad`, one leaf at a
time, so that at most one leaf's float32 temporaries exist beside the
state. The step count, the learning rate and the gradient norm stay 0-d
tensors on the parameters' device: the update never waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.layers import tree_items, tree_map

__all__ = ["OptConfig", "init_opt_state", "schedule", "global_norm",
           "clip_by_global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    m_dtype: Any = torch.float32        # or torch.bfloat16
    v_dtype: Any = torch.float32        # or "qint8"
    q_block: int = 128                  # int8 quantization block (last dim)


# ---------------------------------------------------------------------------
# Block-scaled int8 storage for the (non-negative) second moment
# ---------------------------------------------------------------------------

def _q8_encode(x, block: int):
    """x >= 0, any shape -> (q int8 (rows, blocks, b), scale float32
    (rows, blocks, 1)): one scale per block of the last axis, which is
    zero-padded up to whole blocks."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    b = min(block, max(1, last))
    xp = x.reshape(-1, last)
    pad = -last % b
    if pad:
        xp = torch.nn.functional.pad(xp, (0, pad))
    xb = xp.reshape(xp.shape[0], -1, b)
    scale = torch.amax(xb, dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xb / scale), 0, 127).to(torch.int8)
    return q, scale.float()


def _q8_decode(q, scale, shape):
    x = (q.float() * scale).reshape(q.shape[0], -1)
    last = shape[-1] if shape else 1
    return x[:, :last].reshape(shape)


def _v_init(p, cfg: OptConfig):
    if cfg.v_dtype == "qint8":
        q, s = _q8_encode(torch.zeros(p.shape, device=p.device), cfg.q_block)
        return {"q": q, "scale": s}
    return torch.zeros(p.shape, dtype=cfg.v_dtype, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def init_opt_state(params, cfg: OptConfig):
    """{"m", "v", "count"}: zeroed moments shaped as ``params`` (a qint8
    v is {"q", "scale"} per leaf) and a 0-d int32 step count, on the
    parameters' device."""
    dev = next(t for _, t in tree_items(params)).device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.m_dtype,
                                            device=p.device), params),
        "v": tree_map(lambda p: _v_init(p, cfg), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def schedule(step, cfg: OptConfig):
    """Learning rate at ``step`` (a 0-d integer tensor): linear warmup to
    ``lr``, then a cosine down to ``min_lr_ratio * lr`` at
    ``total_steps``; a float32 tensor on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    """sqrt of the sum over the leaves of their float32 sums of squares."""
    leaves = [torch.sum(torch.square(t.float())) for _, t in tree_items(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(``grads`` in float32 scaled to a global norm of at most
    ``max_norm``, the global norm before)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def _update_leaf(g, m, v, p, scale, lr, bc1, bc2, cfg: OptConfig):
    """One leaf of `adamw_update`, in place: m, v and p."""
    g = g.float() * scale                       # clipped, a new tensor
    m32 = m if m.dtype == torch.float32 else m.float()
    m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    qint8 = cfg.v_dtype == "qint8"
    if qint8:
        v32 = _q8_decode(v["q"], v["scale"], p.shape)
    else:
        v32 = v if v.dtype == torch.float32 else v.float()
    v32.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
    del g
    step_dir = torch.div(m32, bc1)
    step_dir.div_(torch.div(v32, bc2).sqrt_().add_(cfg.eps))
    if cfg.weight_decay and p.dim() >= 2:   # decay matrices, not gains/biases
        step_dir.add_(p.float(), alpha=cfg.weight_decay)
    p32 = p if p.dtype == torch.float32 else p.float()
    p32.sub_(step_dir.mul_(lr))
    if p32 is not p:
        p.copy_(p32)
    if m32 is not m:
        m.copy_(m32)
    if qint8:
        q, s = _q8_encode(v32, cfg.q_block)
        v["q"].copy_(q)
        v["scale"].copy_(s)
    elif v32 is not v:
        v.copy_(v32)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """One AdamW step, IN PLACE on ``params`` and ``opt_state``: count +
    1, the schedule's lr, the gradients clipped by their global norm,
    the moments, the bias-corrected step with decoupled weight decay on
    matrices. Returns (params, opt_state, {"grad_norm", "lr"}), the
    statistics as 0-d tensors on the device."""
    count = opt_state["count"]
    count.add_(1)
    lr = schedule(count, cfg)
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    c = count.float()
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)
    for path, p in tree_items(params):
        m, v = _at(opt_state["m"], path), _at(opt_state["v"], path)
        _update_leaf(_at(grads, path), m, v, p, scale, lr, bc1, bc2, cfg)
    return params, opt_state, {"grad_norm": gn, "lr": lr}


def _at(tree, path):
    """The node of ``tree`` at ``path`` (a qint8 v leaf is its
    {"q", "scale"} dict)."""
    for k in path:
        tree = tree[k]
    return tree
