#!/usr/bin/env python3
"""Profile the port's train step (`repro_torch.train.step`) at
qwen1.5-0.5b's full width and depth on one CUDA card, as `chip_smoke.py`
phase T1 runs it (batch 8 x 256 synthetic tokens, float32 weights from
seed 0, bfloat16 compute, fp32 m and v, TF32 off).

    python3 tools/train_profile.py [--remat none dots full]

For each remat policy (the config's ``remat``; the configs' default is
``dots``): the host wall of a whole step (median of 5 warm, synchronised
steps), the card's busy time and launches of one step
(`chip_smoke.device_busy`, a `torch.profiler` trace) and its peak
`max_memory_allocated`; the same for the loss and its backward alone and
for `adamw_update` alone. Then, for the first policy, the profiler's
operators sorted by device time (the 25 largest) with their call counts
and host time. Writes everything to ``chiprun_out/train_profile.txt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--remat", nargs="+", default=["dots", "none", "full"],
                    choices=["none", "dots", "full"])
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_from_items, tree_items
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.card_line()
    print(card)
    out = [card]
    dev = torch.device("cuda", 0)
    batch = cs.t_batch(get_config(cs.T_ARCH).vocab_size, cs.T_BATCH,
                       cs.T_SEQ)
    oc = cs.t_opt()

    def host(fn, n=5):
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    for i, remat in enumerate(args.remat):
        cfg = dataclasses.replace(get_config(cs.T_ARCH), remat=remat)
        model = build_model(cfg, device=dev)
        state = init_state(model, oc, cs.T_PARAM_SEED, device=dev)
        step = make_train_step(model, oc, cs.batch_tree(batch),
                               device=dev).step_fn
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        items = list(tree_items(state["params"]))
        leaves = [t.requires_grad_() for _, t in items]

        def backward():
            loss, _ = model.loss(state["params"], tb)
            return torch.autograd.grad(loss, leaves)

        grads = tree_from_items((p, g) for (p, _), g in
                                zip(items, backward()))

        def update():
            optim.adamw_update(grads, state["opt"], state["params"], oc)

        parts = {"step": lambda: step(state, batch),
                 "loss + backward": backward, "adamw_update": update}
        for name, fn in parts.items():
            fn()
            torch.cuda.reset_peak_memory_stats()
            wall = host(fn)
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy, launches = cs.device_busy(fn)
            line = (f"remat {remat}, {name}: host wall {wall:.2f} ms (median "
                    f"of 5), card busy {busy:.2f} ms over {launches} "
                    f"launches, idle {1 - busy / wall:.1%}, peak "
                    f"{peak:.3f} GiB [{card}]")
            print(line, flush=True)
            out.append(line)
        if i == 0:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(state, batch)
                torch.cuda.synchronize()
            table = prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=25,
                max_name_column_width=60)
            print(table)
            out += [f"remat {remat}: one step's operators", table]
        del state, grads, leaves, items
        torch.cuda.empty_cache()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "train_profile.txt").write_text("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
