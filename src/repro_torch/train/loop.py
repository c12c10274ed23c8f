"""Training loop (the port's counterpart of the JAX package's
`train/loop.py`): deterministic data replay, periodic (async)
checkpoints, resume from the latest one, and the straggler bookkeeping
of the step times."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.runtime.fault import StragglerDetector

__all__ = ["LoopConfig", "train"]


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_every: int = 0               # 0 = disabled
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    async_ckpt: bool = True


def _wait(device) -> None:
    """Wait for the device's queued work (the reference's
    ``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model, bundle, data_cfg: DataConfig, loop_cfg: LoopConfig,
          state=None, *, device="cuda", log: Optional[Callable] = print):
    """Run steps up to ``loop_cfg.n_steps`` with ``bundle`` (a
    `train.step.StepBundle` made for ``device``). With checkpoints on,
    resumes from the latest one under ``ckpt_dir`` if there is one (else
    from ``state``). Returns (state, history): every ``log_every`` steps
    one entry {"step", "time_s", and the metrics as floats}."""
    dev = resolve_device(device)
    loader = ShardedLoader(data_cfg)
    start = 0
    if loop_cfg.ckpt_every:
        last = ckpt_lib.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            state = ckpt_lib.restore(loop_cfg.ckpt_dir, last,
                                     bundle.abstract_state, device=dev)
            start = last
            if log:
                log(f"[train] resumed from step {last}")
    if state is None:
        raise ValueError("no initial state and no checkpoint")

    det = StragglerDetector()
    history = []
    pending = None
    for step in range(start, loop_cfg.n_steps):
        batch = loader.batch(step)
        t0 = time.perf_counter()
        state, metrics = bundle.step_fn(state, batch)
        _wait(dev)
        dt = time.perf_counter() - t0
        det.record(0, dt)
        if loop_cfg.log_every and (step + 1) % loop_cfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step + 1, "time_s": dt, **m})
            if log:
                log(f"[train] step {step + 1} loss={m['loss']:.4f} "
                    f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                    f"({dt * 1e3:.0f} ms)")
        if loop_cfg.ckpt_every and (step + 1) % loop_cfg.ckpt_every == 0:
            if pending is not None:
                pending.join()
            _, pending = ckpt_lib.save(state, step + 1, loop_cfg.ckpt_dir,
                                       async_write=loop_cfg.async_ckpt)
    if pending is not None:
        pending.join()
    return state, history
