"""Dry run: trace every (arch x shape) cell on the production meshes and
record its per-device operation counts, collectives and roofline (the
port's counterpart of the JAX package's `launch/dryrun.py`).

The reference lowers and compiles each cell with XLA over 512 forced
host devices. Here each cell starts a fake process group (torch's
``"fake"`` backend: 256 ranks for the single-pod 16 x 16 mesh, 512 for
the two-pod 2 x 16 x 16 one, in this one process, collectives that move
nothing), builds the model's state as "meta" ``DTensor``s from the
abstract trees, laid out by the sharding rules, and runs one train step,
prefill or decode through `train.step.make_train_step` /
`serve.step.make_serve_step` as rank 0, counting what that rank runs
(`analysis.op_cost.analyze`) and the bytes it holds (``memory``: the
arguments, the outputs, the peak of what is live through the step and
that peak less the arguments, under the reference's key names; no
``generated_code_size_in_bytes``). Nothing is allocated and no device is
needed. A split moved from one dim to another is counted as the
all-to-all a card's rank runs (`all_to_all_moves`), not as the gather
the fake group's "cpu" mesh would fall back to. A cell that raises is
recorded with ``"status": "fail"`` and its error; no operation is
swapped for another.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_8x256 --mesh 1x1

Besides the reference's flags: ``--shape`` also takes KIND_BxS (e.g.
``train_8x256``, ``decode_4x1024``: a global batch of B sequences of S
tokens), and ``--mesh`` also takes DxM, a (data, model) mesh of D x M
ranks, or PxDxM, a (pod, data, model) one. Each record is
``{out}/{arch}__{shape}__{mesh}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.op_cost import analyze
from repro_torch.analysis.roofline import active_param_count, cell_roofline
from repro_torch.configs import (ASSIGNED, SHAPES, ShapeSpec,
                                 applicable_shapes, get_config, input_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.sharding.rules import Strategy, distribute_tree
from repro_torch.train import optim

__all__ = ["fake_mesh", "all_to_all_moves", "shape_spec", "lower_cell",
           "run_cell", "main"]

_SHAPE_RE = re.compile(r"^(train|prefill|decode)_(\d+)x(\d+)$")
_MESH_RE = re.compile(r"^(\d+)x(\d+)(?:x(\d+))?$")


def shape_spec(name: str) -> ShapeSpec:
    """A registered shape, or KIND_BxS."""
    if name in SHAPES:
        return SHAPES[name]
    m = _SHAPE_RE.match(name)
    if not m:
        raise ValueError(f"shape {name!r}: neither one of {sorted(SHAPES)} "
                         f"nor KIND_BxS")
    return ShapeSpec(name, int(m.group(3)), int(m.group(2)), m.group(1))


def fake_mesh(mesh_kind: str):
    """A ``DeviceMesh`` over a fresh fake process group of as many ranks
    as the mesh has (this process is rank 0): "single" (16 x 16 over
    data, model), "multi" (2 x 16 x 16 over pod, data, model), DxM over
    (data, model) or PxDxM over (pod, data, model). The group serves
    "meta" tensors too. `destroy` it after the cell."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    m = _MESH_RE.match(mesh_kind)
    if m:
        shape = tuple(int(g) for g in m.groups() if g is not None)
        names = ("pod", "data", "model")[-len(shape):]
    else:
        if mesh_kind not in ("single", "multi"):
            raise ValueError(f"mesh {mesh_kind!r}")
        ms = make_production_mesh(multi_pod=mesh_kind == "multi")
        names, shape = ms.axis_names, ms.shape
    dist.init_process_group("cpu:fake,meta:fake", rank=0,
                            world_size=math.prod(shape), store=FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@contextlib.contextmanager
def all_to_all_moves():
    """``DTensor`` moves a split from one tensor dim to another with an
    all-to-all on NCCL, but on a "cpu" mesh (the fake group's) it gathers
    the whole tensor over the mesh dim and keeps its own chunk: it would
    hold, move and count the mesh dim's size times the bytes a card's
    rank does. For the ``with`` block ``DTensor`` calls the all-to-all
    itself, which the fake group serves (counted as "all-to-all")."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt

    op = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)

    def alltoall(tensor, gather_dim, shard_dim, mesh, mesh_dim):
        return op(tensor, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)

    saved = [(m, m.shard_dim_alltoall) for m in (cu, pt)
             if op is not None and hasattr(m, "shard_dim_alltoall")]
    for m, _ in saved:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in saved:
            m.shard_dim_alltoall = f


def _opt_config_for(cfg):
    # the 400B MoE config needs compact moments, as in the reference
    if cfg.name.startswith("llama4"):
        return optim.OptConfig(m_dtype=torch.bfloat16, v_dtype="qint8")
    return optim.OptConfig()


def _configured(arch: str, overrides: dict | None):
    cfg = get_config(arch)
    for key, val in (overrides or {}).items():  # e.g. {"ssm.impl": "matmul"}
        if key.startswith("ssm."):
            cfg = dataclasses.replace(
                cfg, ssm=dataclasses.replace(cfg.ssm, **{key[4:]: val}))
        elif key.startswith("moe."):
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **{key[4:]: val}))
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def lower_cell(arch: str, shape_name: str, mesh, strategy: str = None,
               overrides: dict = None, config=None):
    """(step function, its arguments, meta) of one cell: the state (or
    parameters and cache) as "meta" ``DTensor``s on ``mesh``. ``config``
    (e.g. `configs.reduced`'s cut of ``arch``) stands in for the
    registered one."""
    from repro_torch.serve.step import make_serve_step
    from repro_torch.train.step import distribute_state, make_train_step

    cfg = config or _configured(arch, overrides)
    shape = shape_spec(shape_name)
    model = build_model(cfg, device="cpu")
    batch = input_specs(cfg, shape)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "n_params": L.param_count(model.schema)}
    if shape.kind == "train":
        bundle = make_train_step(
            model, _opt_config_for(cfg),
            {k: (tuple(t.shape), t.dtype) for k, t in batch.items()},
            device="meta", mesh=mesh, strategy=Strategy(strategy or "train"))
        state = distribute_state(bundle.abstract_state, bundle)
        return bundle.step_fn, (state, batch), meta
    bundle = make_serve_step(model, mesh, batch,
                             batch_size=shape.global_batch,
                             max_len=shape.seq_len,
                             strategy=Strategy(strategy or "serve"))
    args = (distribute_tree(bundle.abstract_params, bundle.param_shardings),
            distribute_tree(batch, bundle.batch_shardings),
            distribute_tree(bundle.abstract_cache, bundle.cache_shardings))
    fn = bundle.prefill_fn if shape.kind == "prefill" else bundle.decode_fn
    return fn, args, meta


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             strategy: str = None, overrides: dict = None, tag: str = "",
             config=None, by_op: int = 0):
    import torch.distributed as dist

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "strategy": strategy or "default", "overrides": overrides or {}}
    try:
        mesh = fake_mesh(mesh_kind)
        try:
            rec["devices"] = mesh.size()
            fn, args, meta = lower_cell(arch, shape_name, mesh, strategy,
                                        overrides, config)
            rec.update(meta)
            t1 = time.time()
            with all_to_all_moves():
                rec["op_cost"] = analyze(fn, *args, by_op=by_op)
            rec["trace_s"] = round(time.time() - t1, 1)
            rec["memory"] = rec["op_cost"].pop("memory")
            rec["roofline"] = cell_roofline(rec, active_param_count(arch))
            rec["status"] = "ok"
        finally:
            dist.destroy_process_group()
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)

    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = (f"__{strategy}" if strategy else "") + (f"__{tag}" if tag else "")
    fn = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    fn.write_text(json.dumps(rec, indent=1))
    status = rec["status"]
    extra = "" if status == "ok" else f"  !! {rec.get('error', '')[:160]}"
    print(f"[dryrun] {arch:28s} {shape_name:12s} {mesh_kind:6s} {status}"
          f"  ({rec['total_s']}s){extra}", flush=True)
    if status == "ok" and by_op:
        total = rec["op_cost"]["flops"]
        for e in rec["op_cost"]["by_op"]:
            print(f"  {e['flops']:.4e} {e['flops'] / total:6.1%} {e['op']} "
                  f"{' @ '.join(map(str, e['shapes']))}  {e['site']}",
                  flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both | DxM | PxDxM")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--strategy", default=None,
                    help="override sharding strategy (e.g. fsdp)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. ssm.impl=matmul)")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--by-op", type=int, default=0, metavar="N",
                    help="print (and record) each cell's N largest "
                         "products by FLOPs, with their local shapes and "
                         "the port's frame that ran them")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    out_dir = Path(args.out)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ASSIGNED:
            for shape in applicable_shapes(get_config(arch)):
                for mk in meshes:
                    cells.append((arch, shape, mk))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mk in meshes:
            cells.append((args.arch, args.shape, mk))

    n_fail = 0
    for arch, shape, mk in cells:
        suffix = f"__{args.strategy}" if args.strategy else ""
        fn = out_dir / f"{arch}__{shape}__{mk}{suffix}.json"
        if args.skip_existing and fn.exists():
            rec = json.loads(fn.read_text())
            if rec.get("status") == "ok":
                print(f"[dryrun] {arch:28s} {shape:12s} {mk:6s} cached-ok",
                      flush=True)
                continue
        rec = run_cell(arch, shape, mk, out_dir, args.strategy, overrides,
                       args.tag, by_op=args.by_op)
        n_fail += rec["status"] != "ok"
    print(f"[dryrun] done, {n_fail} failures", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
