"""Serving CLI: batched decode with the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --device cpu --requests 6 --max-new 16

Random weights from ``--seed``, drawn and cast one leaf at a time
(`init_cast_params`, so deepseek-moe-16b loads on one 80 GB card);
prompts of 2-7 tokens drawn from the same seed. qwen2-vl-2b needs
M-RoPE positions in every call, which the engine does not pass (nor
does the reference's). Runs on the card by default (``--device cuda``) and prints the
generated tokens per second of wall time on the named device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model, init_cast_params
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
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
    params = init_cast_params(model, args.seed, device=dev)
    eng = Engine(model, params, slots=args.slots, max_len=args.max_len,
                 temperature=args.temperature, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(2, 8))
        prompt = rng.integers(1, cfg.vocab_size, size=plen).tolist()
        eng.add_request(Request(rid, prompt, max_new=args.max_new))
    done = eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {len(done)} requests, {tok} tokens, "
          f"{tok / dt:.1f} tok/s on {name}")
    return done


if __name__ == "__main__":
    main()
