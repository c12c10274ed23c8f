"""Training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 200 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --device cpu --steps 20 --ckpt-dir ckpts --ckpt-every 10

The reference's flags, plus ``--device`` (default ``cuda``: the run
raises on a host without a card unless given ``--device cpu``). Random
float32 weights from ``--seed``, synthetic (or ``--data memmap
--data-path FILE``) batches from `data.pipeline.ShardedLoader`, AdamW
with a warmup of max(10, steps / 20) and a cosine to ``--steps``. With
``--ckpt-every`` it checkpoints under ``--ckpt-dir`` (default
``checkpoints``) and resumes from the latest step there. An
encoder-decoder config's step also takes ``frames``, which the token
loader does not make: the step refuses such a batch, as the reference's
does.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import optim
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # XLA's einsum accumulates in float32: keep cuBLAS from reducing
        # split-K partials in bfloat16, and float32 products out of TF32
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=dev)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed,
                    source=args.data, path=args.data_path)
    oc = optim.OptConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                         total_steps=args.steps)
    batch_tree = {"tokens": ((args.batch, args.seq), torch.int32),
                  "labels": ((args.batch, args.seq), torch.int32)}
    if cfg.is_encdec:
        batch_tree["frames"] = ((args.batch, cfg.enc_ctx, cfg.d_model),
                                cfg.compute_dtype)
    bundle = make_train_step(model, oc, batch_tree, device=dev)
    state = init_state(model, oc, args.seed, device=dev)
    lc = LoopConfig(n_steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir or "checkpoints",
                    log_every=max(1, args.steps // 20))
    return train(model, bundle, dc, lc, state, device=dev)


if __name__ == "__main__":
    main()
