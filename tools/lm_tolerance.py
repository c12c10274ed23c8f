#!/usr/bin/env python3
"""What `chip_smoke.py`'s `LM_TOL`, `WHISPER_TOL` and `M_TOL` have to
separate, read on the CPU at the models' layer widths with the depth and
the vocabulary cut.

    PYTHONPATH=src python3 tools/lm_tolerance.py [--layers 4 8 12] \
        [--vocab 32768]
    PYTHONPATH=src python3 tools/lm_tolerance.py --arch whisper-medium \
        [--layers 2 4] [--vocab 32768]
    PYTHONPATH=src python3 tools/lm_tolerance.py --arch deepseek-moe-16b \
        [--layers 2 4] [--vocab 32768]     # also rwkv6-7b, zamba2-7b

qwen1.5-0.5b, for each depth: 4 prompts of 64-300 tokens are prefilled
and then decoded 8 steps teacher-forced in bfloat16; each step's logits
are held against `model.forward` over the extended sequences (relative
L2 error, as phase L2 reads it), and so are the logits of the same
decode with its rope angle one position late (what phase L3's check
must flag). It also prints bfloat16 against float32 compute of the
forward, the whole rounding error of the compute dtype.

whisper-medium, for each depth (that many encoder and decoder layers):
one 8-token decoder prompt over the encoder output of 1,500 frames from
a seed (phase P3's card-against-CPU input) is prefilled and decoded 4
steps teacher-forced; each step's logits against `model.forward`, the
same decode with its sinusoidal position one late, the same decode with
the encoder K/V of the cache zeroed (a prefill that stored none), and
bfloat16 against float32 compute of the forward.

deepseek-moe-16b, rwkv6-7b and zamba2-7b (phase M), for each depth
(zamba2: a multiple of 6 includes its shared attention block): 2
prompts of 96 tokens are prefilled and decoded 4 steps teacher-forced in
bfloat16 (MoE at a capacity factor of E/k, which drops nothing), each
step's logits against `model.forward`; the same decodes under phase M's
mis-computation (`chip_smoke.family_wrong`); bfloat16 against float32
compute of the forward and, for MoE, the share of top-k choices that
differ between the two.

Random weights from seed 0 (the families' drawn and cast one leaf at a
time). Seconds to a minute a depth; nothing here runs on a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=["qwen1.5-0.5b", "whisper-medium", *FAMILIES])
    ap.add_argument("--layers", type=int, nargs="+", default=None)
    ap.add_argument("--vocab", type=int, default=32768)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.arch == "whisper-medium":
        for n_layers in args.layers or [2, 4]:
            whisper_readings(n_layers, args.vocab)
        return 0
    if args.arch in FAMILIES:
        for n_layers in args.layers or FAMILIES[args.arch]:
            family_readings(args.arch, n_layers, args.vocab)
        return 0

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, cast_params, init_cache,
                                    init_model_params)
    from repro_torch.models import attention as att
    from repro_torch.models.layers import tree_map

    right = att.apply_rope
    for n_layers in args.layers or [4, 8, 12]:
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                                  num_layers=n_layers, vocab_size=args.vocab)
        model = build_model(cfg, device="cpu")
        params = cast_params(model, init_model_params(model, 0, device="cpu"))
        rng = np.random.default_rng(1)
        lens = rng.integers(64, 301, 4)
        seqs = [rng.integers(1, cfg.vocab_size, n + 8) for n in lens]
        toks = np.zeros((4, lens.max() + 8), np.int64)
        for b, seq in enumerate(seqs):
            toks[b, :len(seq)] = seq
        with torch.no_grad():
            full, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
            cache = init_cache(model, 4, 1024, device="cpu")
            first = toks[:, :lens.max()] * (np.arange(lens.max())[None, :]
                                            < lens[:, None])
            _, cache = model.prefill(params, {"tokens": torch.as_tensor(
                first)}, cache)
            late = tree_map(torch.clone, cache)
            errs, wrong = [], []
            for t in range(8):
                batch = {"tokens": torch.as_tensor(
                    [[s[n + t]] for s, n in zip(seqs, lens)]),
                         "cache_len": torch.as_tensor(lens + t)}
                want = full[torch.arange(4), torch.as_tensor(lens + t)]
                got, cache = model.decode(params, batch, cache)
                errs.append(rel_err(got[:, 0], want))
                att.apply_rope = lambda x, pos, **kw: right(x, pos + 1, **kw)
                try:
                    got, late = model.decode(params, batch, late)
                finally:
                    att.apply_rope = right
                wrong.append(rel_err(got[:, 0], want))
            f32 = build_model(dataclasses.replace(
                cfg, compute_dtype=torch.float32), device="cpu")
            full32, _ = f32.forward(params, {"tokens": torch.as_tensor(toks)})
            dtype_err = [rel_err(full[b, :lens[b] + 8], full32[b, :lens[b] + 8])
                         for b in range(4)]
        print(f"{n_layers} layers, vocab {args.vocab} (CPU): cache vs "
              f"forward {min(errs):.5f}-{max(errs):.5f}; late rope angle "
              f"{min(wrong):.5f}-{max(wrong):.5f}; bfloat16 vs float32 "
              f"forward {min(dtype_err):.5f}-{max(dtype_err):.5f}")
    return 0


WHISPER_PROMPT, WHISPER_STEPS, WHISPER_FRAMES = 8, 4, 1500
# phase M's families and their default depths
FAMILIES = {"deepseek-moe-16b": [2, 4], "rwkv6-7b": [2, 4, 8],
            "zamba2-7b": [6, 12]}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS = 2, 96, 4


def family_readings(arch: str, n_layers: int, vocab: int) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_cache, init_cast_params

    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers,
                              vocab_size=vocab)
    model = build_model(cfg, device="cpu")
    params = init_cast_params(model, 0, device="cpu")
    if cfg.moe is not None:   # decodes at a capacity that drops nothing
        m = cfg.moe
        model = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k)), device="cpu")
    rng = np.random.default_rng(1)
    n = FAMILY_PROMPT
    toks = rng.integers(1, vocab, (FAMILY_BATCH, n + FAMILY_STEPS))
    what, wrong = cs.family_wrong(arch)
    with torch.no_grad():
        with cs.TopK() as bf16_routes:
            full, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
        runs = {}
        for tag in ("right", "wrong"):
            with (wrong if tag == "wrong" else cs.contextlib.nullcontext()):
                cache = init_cache(model, FAMILY_BATCH, 256, device="cpu")
                _, cache = model.prefill(params, {"tokens": torch.as_tensor(
                    toks[:, :n])}, cache)
                errs = []
                for t in range(FAMILY_STEPS):
                    got, cache = model.decode(params, cs.decode_step_batch(
                        cfg, toks[:, n + t:n + t + 1], n + t, "cpu"), cache)
                    errs.append(rel_err(got[:, 0], full[:, n + t]))
            runs[tag] = errs
        f32 = build_model(dataclasses.replace(
            model.cfg, compute_dtype=torch.float32), device="cpu")
        with cs.TopK() as f32_routes:
            full32, _ = f32.forward(params, {"tokens": torch.as_tensor(toks)})
        dtype_err = rel_err(full, full32)
    flips = ""
    if cfg.moe is not None:
        a = torch.cat([r.reshape(-1) for r in bf16_routes.calls])
        b = torch.cat([r.reshape(-1) for r in f32_routes.calls])
        flips = (f"; top-{cfg.moe.top_k} choices differing bfloat16 vs "
                 f"float32 {float((a != b).float().mean()):.2%} of "
                 f"{a.numel()}")
    print(f"{arch} {n_layers} layers, vocab {vocab} (CPU): cache vs forward "
          f"{min(runs['right']):.5f}-{max(runs['right']):.5f}; {what} "
          f"{min(runs['wrong']):.5f}-{max(runs['wrong']):.5f}; bfloat16 vs "
          f"float32 forward {dtype_err:.5f}{flips}", flush=True)



def whisper_readings(n_layers: int, vocab: int) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, cast_params, init_cache,
                                    init_model_params)
    from repro_torch.models import api
    from repro_torch.models.layers import tree_map

    cfg = dataclasses.replace(get_config("whisper-medium"),
                              num_layers=n_layers, encoder_layers=n_layers,
                              vocab_size=vocab)
    model = build_model(cfg, device="cpu")
    params = cast_params(model, init_model_params(model, 0, device="cpu"))
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(
        1, vocab, (1, WHISPER_PROMPT + WHISPER_STEPS)))
    frames = torch.as_tensor(rng.normal(
        0, 1, (1, WHISPER_FRAMES, cfg.d_model)).astype(np.float32))
    table = api.L.sinusoidal_positions
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks, "frames": frames})
        cache = init_cache(model, 1, 64, device="cpu")
        _, cache = model.prefill(params, {
            "tokens": toks[:, :WHISPER_PROMPT], "frames": frames}, cache)
        late = tree_map(torch.clone, cache)
        blind = tree_map(torch.clone, cache)
        for leaf in ("ek", "ev"):
            blind["seg0"]["l0_cross"][leaf].zero_()
        errs, wrong, zero = [], [], []
        for t in range(WHISPER_STEPS):
            n = WHISPER_PROMPT + t
            batch = {"tokens": toks[:, n:n + 1],
                     "cache_len": torch.as_tensor([n])}
            want = full[:, n]
            got, cache = model.decode(params, batch, cache)
            errs.append(rel_err(got[:, 0], want))
            api.L.sinusoidal_positions = \
                lambda s, d, dt, dev: table(s, d, dt, dev)[1:]
            try:
                got, late = model.decode(params, batch, late)
            finally:
                api.L.sinusoidal_positions = table
            wrong.append(rel_err(got[:, 0], want))
            got, blind = model.decode(params, batch, blind)
            zero.append(rel_err(got[:, 0], want))
        f32 = build_model(dataclasses.replace(
            cfg, compute_dtype=torch.float32), device="cpu")
        full32, _ = f32.forward(params, {"tokens": toks, "frames": frames})
        dtype_err = rel_err(full, full32)
    print(f"whisper-medium {n_layers} + {n_layers} layers, vocab {vocab}, "
          f"{WHISPER_FRAMES} frames (CPU): cache vs forward "
          f"{min(errs):.5f}-{max(errs):.5f}; sinusoidal position one late "
          f"{min(wrong):.5f}-{max(wrong):.5f}; encoder K/V zeroed "
          f"{min(zero):.5f}-{max(zero):.5f}; bfloat16 vs float32 forward "
          f"{dtype_err:.5f}")


if __name__ == "__main__":
    sys.exit(main())
