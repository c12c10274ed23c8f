#!/usr/bin/env python3
"""Profile the port's LM path (`repro_torch.models`) at qwen1.5-0.5b's full
width on one CUDA card: one padded prefill and one decode step of a
4-slot batch, as `chip_smoke.py` phase L's engine runs them.

    python3 tools/lm_profile.py [--slots 4] [--width 512] [--max-len 1024]

Prints, for prefill and decode: the card's busy time and launches of one
call (`chip_smoke.device_busy`, a `torch.profiler` trace) and its host
wall time (`chip_smoke.host_ms`, synchronised); then the profiler's
operators sorted by device time (the 20 largest) with their call counts
and host time. Writes the tables to
``chiprun_out/lm_profile.txt``. Random weights from seed 0; bfloat16
compute, float32 parameters, TF32 and bfloat16 split-K reductions off.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--max-len", type=int, default=1024)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, device_busy, host_ms
    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, cast_params, init_cache,
                                    init_model_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    model = build_model(get_config("qwen1.5-0.5b"), device=dev)
    params = cast_params(model, init_model_params(model, 0, device=dev))
    cache = init_cache(model, args.slots, args.max_len, device=dev)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(1, 151936, (args.slots,
                                                      args.width)),
                             device=dev)
    _, cache = model.prefill(params, {"tokens": tokens}, cache)
    step = {"tokens": tokens[:, -1:],
            "cache_len": torch.full((args.slots,), args.width - 1,
                                    device=dev)}
    calls = {
        f"prefill {args.slots} x {args.width}":
            lambda: model.prefill(params, {"tokens": tokens}, cache),
        f"decode {args.slots} slots":
            lambda: model.decode(params, step, cache),
    }
    out = [card]
    with torch.no_grad():
        for name, fn in calls.items():
            (busy, launches), wall = device_busy(fn), host_ms(fn, 10)
            line = (f"{name}: card busy {busy:.3f} ms over {launches} "
                    f"launches, host wall {wall:.3f} ms [{card}]")
            print(line)
            out.append(line)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            table = prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=20, max_name_column_width=60)
            print(table)
            out += [name, table]
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "lm_profile.txt").write_text("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
