"""Checkpoints (the port's counterpart of the JAX package's
`checkpoint/ckpt.py`), in the reference's on-disk layout:

    <dir>/step_<n:08d>/
        meta.json          {"step": n, "leaves": {path: {file, shape, dtype}}}
        <flat.key>.npy     one file per leaf (the full array)

A leaf is addressed by its flattened tree path ("opt/m/embed/embedding"),
so either package restores the other's checkpoint of the same tree
(float32, int32 and int8 leaves bitwise). numpy has no bfloat16 (the
reference writes the `ml_dtypes` type, which the card's machine lacks):
the port stores a bfloat16 leaf as its raw 16 bits, a uint16 `.npy` with
``"bfloat16"`` in `meta.json`, and restores it bitwise.

`save` copies every leaf to the host synchronously (the caller may
update the state in place right after) and writes the files, on a thread
when asked (``async_write``); a step's directory is written under
``.tmp`` and renamed when complete, so `latest_step` never sees a partial
one.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["save", "latest_step", "restore"]

_BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(flat: dict, template):
    def rec(node, prefix=""):
        if isinstance(node, dict):
            return {k: rec(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return flat[prefix[:-1]]

    return rec(template)


def _to_host(t) -> tuple:
    """(numpy array to write, the dtype name for meta.json)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
        a = t.cpu().numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def save(state, step: int, ckpt_dir: str, *, async_write: bool = False):
    """Write ``state`` (a tree of tensors) as step ``step`` under
    ``ckpt_dir``. Returns (the step's directory, the writing thread if
    ``async_write`` else None): join the thread before reading it."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    host = {k: _to_host(v) for k, v in _flatten(state).items()}

    def write():
        tmp.mkdir(parents=True, exist_ok=True)
        meta = {}
        for k, (a, dtype) in host.items():
            fn = k.replace("/", ".") + ".npy"
            np.save(tmp / fn, a)
            meta[k] = {"file": fn, "shape": list(a.shape), "dtype": dtype}
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "leaves": meta}))
        tmp.rename(d)                  # atomic publish

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return d, t
    write()
    return d, None


def latest_step(ckpt_dir: str) -> int | None:
    """The highest complete step under ``ckpt_dir``, or None."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if (p / "meta.json").exists())
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template, *, device="cuda"):
    """Step ``step`` of ``ckpt_dir`` in the structure of ``template`` (a
    tree whose leaves may be anything: only its nesting and names are
    read), each leaf a tensor on ``device`` (default the card) with the
    dtype it was written in."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    flat = {}
    for k in _flatten(template):
        info = meta["leaves"][k]
        a = np.load(d / info["file"])
        if info["dtype"] == _BF16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        flat[k] = t.to(dev)
    return _unflatten_into(flat, template)
