#!/usr/bin/env python3
"""The JAX package's dry run on meshes with Auto axes, and its records
set beside the port's, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/dryrun_reference.py \
        --out results/dryrun [--cells ARCH,SHAPE,MESH ...]
    PYTHONPATH=src python3 tools/dryrun_reference.py --compare \
        --out results/dryrun --port results/dryrun_torch

Without ``--compare`` it runs the reference's `launch/dryrun.py:run_cell`
(lower, compile, `analysis/hlo_cost.py`) for every cell of `--all` on
both production meshes, or the given cells, with `make_production_mesh`
swapped for one that builds the same 16 x 16 or 2 x 16 x 16 mesh with
``AxisType.Auto`` axes over the first 256 or 512 of the 512 host devices
the module forces (jax 0.9's default Explicit axes make the reference's
constraints refuse the mesh: ROADMAP C.2). `src/repro` is not edited.
About a minute for all 66 cells.

With ``--pp`` it runs the reference's `launch/dryrun_pp.py` the same way
(its record under ``OUT/results/dryrun/``).

With ``--compare`` it prints one markdown row a cell of the port's
records (`python -m repro_torch.launch.dryrun --all --mesh both`):
status, trace seconds, per-device FLOPs of both and their ratio, the
port's peak memory a device (with its arguments) and whether it fits
one H100's 80 GB, the reference's XLA memory analysis (arguments,
outputs, temporaries), collectives by kind, and the port's H100
roofline (dominant term, bound). The two memories are different
accountings: the port's is eager liveness through the step
(`analysis/op_cost.py`), the reference's XLA's buffer assignment over
the compiled program.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H100_BYTES = 80e9        # one H100's 80 GB of device memory
SHORT = {"all-reduce": "AR", "all-gather": "AG", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP",
         "collective-broadcast": "BC", "send": "S", "recv": "R"}


def run_reference(out: Path, cells: list) -> None:
    os.environ["_REPRO_EXTRA_XLA_FLAGS"] = ""
    import repro.launch.dryrun as D      # forces 512 host devices

    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh

    def auto_production_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        devices = np.array(jax.devices()[:int(np.prod(shape))])
        return Mesh(devices.reshape(shape), axes,
                    axis_types=(AxisType.Auto,) * len(shape))

    D.make_production_mesh = auto_production_mesh
    if not cells:
        from repro.configs import ASSIGNED, applicable_shapes, get_config
        cells = [(a, s, m) for a in ASSIGNED
                 for s in applicable_shapes(get_config(a))
                 for m in ("single", "multi")]
    for arch, shape, mesh in cells:
        D.run_cell(arch, shape, mesh, out)


def run_reference_pp(out: Path) -> None:
    """The reference's `launch/dryrun_pp.py` with its (pipe 8, data 64)
    mesh built with Auto axes; its record lands under ``out``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import AxisType

    make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, names, **kw: make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(shape), **kw)
    import repro.launch.dryrun_pp as pp

    out.mkdir(parents=True, exist_ok=True)
    os.chdir(out)               # it writes results/dryrun/ under the cwd
    pp.main()


def _colls(c: dict) -> str:
    return " ".join(f"{SHORT.get(k, k)} {int(v['count'])}"
                    for k, v in sorted(c.items())) or "none"


def _load(path: Path) -> dict:
    return json.loads(path.read_text()) if path.is_file() else {}


def _gib(n) -> str:
    return f"{n / 2**30:.3g}"


def compare(ref_dir: Path, port_dir: Path) -> None:
    """One row a cell of the port's records: status, trace seconds,
    per-device FLOPs (port / reference), memory of both and whether the
    port's peak fits one H100 (`H100_BYTES`), collectives by kind and
    the port's H100 roofline (dominant term, bound)."""
    print("| arch | shape | mesh | status | trace s | FLOPs a device, port "
          "(port / ref) | peak GiB, port (args) | fits 80 GB | ref GiB: "
          "args + out + temp | collectives, port; ref | dominant, bound "
          "ms |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
          "| --- |")
    cells = sorted({tuple(f.name.split("__")[:3])
                    for f in port_dir.glob("*__*__*.json")},
                   key=lambda c: (c[0], c[1], c[2] != "single"))
    for arch, shape, mesh in cells:
        mesh = mesh.removesuffix(".json")
        port = _load(port_dir / f"{arch}__{shape}__{mesh}.json")
        ref = _load(ref_dir / f"{arch}__{shape}__{mesh}.json")
        status = port.get("status", "not run")
        if status == "fail":
            status = "fail: " + port.get("error", "").split(":")[0]
        oc, hc = port.get("op_cost"), ref.get("hlo_cost")
        mem, rmem = port.get("memory", {}), ref.get("memory", {})
        flops = peak = fits = colls = roof = "-"
        if oc:
            ratio = f" ({oc['flops'] / hc['flops']:.3f})" if hc else ""
            flops = f"{oc['flops']:.4g}{ratio}"
            colls = _colls(oc["collectives"]) + (
                f"; {_colls(hc['collectives'])}" if hc else "")
            rl = port["roofline"]
            roof = f"{rl['dominant'][:4]}, {rl['bound_s'] * 1e3:.4g}"
        if "peak_bytes" in mem:
            peak = (f"{_gib(mem['peak_bytes'])} "
                    f"({_gib(mem['argument_size_in_bytes'])})")
            fits = "yes" if mem["peak_bytes"] <= H100_BYTES else "no"
        rgib = (" + ".join(_gib(rmem.get(k, 0)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes")) if rmem else "-")
        print(f"| {arch} | {shape} | {mesh} | {status} | "
              f"{port.get('trace_s', '-')} | {flops} | {peak} | {fits} | "
              f"{rgib} | {colls} | {roof} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--cells", nargs="*", default=[],
                    help="ARCH,SHAPE,MESH (default: every cell of --all "
                         "on both meshes)")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--pp", action="store_true",
                    help="the reference's dryrun_pp cell instead")
    ap.add_argument("--port", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.compare:
        compare(Path(args.out), Path(args.port))
    elif args.pp:
        run_reference_pp(Path(args.out).resolve())
    else:
        run_reference(Path(args.out),
                      [tuple(c.split(",")) for c in args.cells])
    return 0


if __name__ == "__main__":
    sys.exit(main())
