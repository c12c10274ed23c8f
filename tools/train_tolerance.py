#!/usr/bin/env python3
"""What `chip_smoke.py`'s `TRAIN_TOL` (phase T's card-against-CPU check
of the loss and the gradient tree) has to separate, read on the CPU at
the models' full widths with the depth cut.

    PYTHONPATH=src python3 tools/train_tolerance.py [--layers 2 4]
    PYTHONPATH=src python3 tools/train_tolerance.py \
        --arch deepseek-moe-16b [--layers 2]

For each depth, on one batch of phase T's synthetic data (qwen1.5-0.5b 2
x 128 tokens, deepseek-moe-16b 1 x 256) and the same float32 weights
from seed 0: the loss and the gradient tree in bfloat16 compute against
float32 compute (relative L2 error over the whole tree: the whole
rounding error of the compute dtype, which bounds what two devices
computing both in bfloat16 can read apart), and, for qwen, the gradient
tree with the head's use of the tied embedding detached against the
right one (phase T's mis-computation), and one `adamw_update` on these
gradients without its bias correction against the right one. MoE runs
the float32 pass on the bfloat16 pass's routing (as phase T's CPU
replays the card's) and prints the share of top-k choices that differ
when it routes on its own. Seconds to a minute a depth; nothing here
runs on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=["qwen1.5-0.5b", "deepseek-moe-16b"])
    ap.add_argument("--layers", type=int, nargs="+", default=[2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_from_items, tree_items
    from repro_torch.train import optim
    from repro_torch.train.step import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config(args.arch)
    rows_seq = cs.T2_CPU_BATCH if full.moe else cs.T_CPU_BATCH
    for n_layers in args.layers:
        cfg = dataclasses.replace(full, num_layers=n_layers)
        bf16 = build_model(cfg, device="cpu")
        f32 = build_model(dataclasses.replace(cfg,
                                              compute_dtype=torch.float32),
                          device="cpu")
        params = init_state(bf16, optim.OptConfig(), cs.T_PARAM_SEED,
                            device="cpu")["params"]
        batch = cs.t_batch(cfg.vocab_size, *rows_seq)
        with cs.TopK() as rec:
            loss, _, grads = cs.loss_and_grads(bf16, params, batch, "cpu")
        with cs.TopK(rec.calls if cfg.moe else None):
            loss32, _, grads32 = cs.loss_and_grads(f32, params, batch, "cpu")
        line = (f"{args.arch} {n_layers} layers, {rows_seq[0]} x "
                f"{rows_seq[1]} tokens: bfloat16 vs float32 compute loss "
                f"{loss:.6f} / {loss32:.6f} (relative "
                f"{abs(loss - loss32) / abs(loss32):.2e}), gradient tree "
                f"{cs.tree_rel_err(grads, grads32):.5f}")
        if cfg.moe:
            with torch.no_grad(), cs.TopK() as own:
                f32.loss(params, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
            a = torch.cat([r.reshape(-1) for r in
                           rec.calls[:len(own.calls)]])
            b = torch.cat([r.reshape(-1) for r in own.calls])
            line += (f"; {float((a != b).float().mean()):.2%} of "
                     f"{a.numel()} top-{cfg.moe.top_k} choices differ "
                     f"unreplayed")
        else:
            with cs.head_detached():
                _, _, bad = cs.loss_and_grads(bf16, params, batch, "cpu")
            line += (f"; the head's use of the embedding detached "
                     f"{cs.tree_rel_err(bad, grads):.5f}")
            paths = [p for p, _ in tree_items(params)]
            oc = cs.t_opt()

            def update(wrong):
                p = tree_from_items((k, t.detach().clone())
                                    for k, t in tree_items(params))
                g = tree_from_items(zip(paths, grads))
                with (cs.no_bias_correction() if wrong
                      else cs.contextlib.nullcontext()):
                    optim.adamw_update(g, optim.init_opt_state(p, oc), p, oc)
                return [a.detach() - b.detach() for (_, a), (_, b) in
                        zip(tree_items(p), tree_items(params))]

            line += (f"; adamw_update without its bias correction "
                     f"{cs.tree_rel_err(update(True), update(False)):.5f}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
