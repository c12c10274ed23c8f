"""Pipeline-parallel dry run: trace a GPipe'd dense stack on the 512-rank
mesh laid out as (pipe 8, data 64), the reference's
`launch/dryrun_pp.py` cell, on a fake process group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pp [--out DIR]

The stack is the reference's: 24 layers of h + tanh(h @ w1) @ w2 at
qwen1.5-0.5b's widths (d 1024, d_ff 2816) in bfloat16, 3 layers a stage
over 8 stages, a global batch of 256 x 512 over the data axis, 4
microbatches. Rank 0 (stage 0, data block 0) runs its part of the
schedule on "meta" tensors through `sharding.pipeline.gpipe_apply`,
and `analysis.op_cost` counts what it runs; the record holds the bubble
fraction (7 / 11) and the point-to-point count (each tick but the last
hands one microbatch on: 10 sends and 10 receives a rank).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.analysis.op_cost import analyze
from repro_torch.sharding.pipeline import bubble_fraction, gpipe_apply

__all__ = ["run", "main"]

D, D_FF = 1024, 2816            # qwen1.5-0.5b-scale dense layer
LAYERS, STAGES = 24, 8
BATCH, SEQ = 256, 512
MICROBATCHES = 4


def layer(p, h):
    w1, w2 = p
    return h + torch.tanh(h @ w1) @ w2


def run(out_dir: Path) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t0 = time.time()
    dist.init_process_group("cpu:fake,meta:fake", rank=0, world_size=512,
                            store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (STAGES, 512 // STAGES),
                                mesh_dim_names=("pipe", "data"))
        meta = torch.device("meta")
        params = (torch.empty(STAGES, LAYERS // STAGES, D, D_FF,
                              dtype=torch.bfloat16, device=meta),
                  torch.empty(STAGES, LAYERS // STAGES, D_FF, D,
                              dtype=torch.bfloat16, device=meta))
        x = torch.empty(BATCH, SEQ, D, dtype=torch.bfloat16, device=meta)
        cost = analyze(lambda p, h: gpipe_apply(
            layer, p, h, mesh=mesh, microbatches=MICROBATCHES,
            batch_axis="data"), params, x)
    finally:
        dist.destroy_process_group()
    rec = {
        "mesh": {"pipe": STAGES, "data": 512 // STAGES},
        "layers": LAYERS, "stages": STAGES, "microbatches": MICROBATCHES,
        "bubble_fraction": bubble_fraction(STAGES, MICROBATCHES),
        "trace_s": round(time.time() - t0, 1),
        "memory": cost.pop("memory"),
        "op_cost": cost,
        "point_to_point": {k: cost["collectives"].get(k, {"count": 0})
                           ["count"] for k in ("send", "recv")},
        "status": "ok",
    }
    out = out_dir / "pp__dense24__pipe8.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun_pp] ok trace={rec['trace_s']}s "
          f"bubble={rec['bubble_fraction']:.4f} "
          f"sends={rec['point_to_point']['send']} "
          f"recvs={rec['point_to_point']['recv']} "
          f"flops/rank={cost['flops']:.4e}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    run(Path(ap.parse_args(argv).out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
