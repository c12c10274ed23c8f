#!/usr/bin/env python3
"""The families' bfloat16 decode-against-forward error in the JAX package
and in the port, side by side, on the CPU, with the same weights.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/cache_vs_forward_reference.py \
        [--arch deepseek-moe-16b rwkv6-7b zamba2-7b]

What `chip_smoke.py`'s `M_CACHE_TOL` gates on the card (phase M): 2
prompts of 96 tokens prefilled and decoded 4 steps teacher-forced in
bfloat16 compute, each step's logits against `model.forward` over the
extended sequences (relative L2 error; MoE at a capacity factor of E/k,
which drops nothing). Here both packages run it at `tools/lm_tolerance.py`'s
depths (deepseek 2 and 4 layers, rwkv6 2, 4 and 8, zamba2 6 and 12) with
the widths cut to fit the CPU (`WIDTHS`: d_model 256, 4 heads of 64, d_ff
512, vocab 4096; MoE 8 routed experts top-2 of 128 plus the shared ones;
the recurrent head and state sizes 32), float32 weights drawn by the
reference from seed 0 and carried into the port (`params_from_numpy`).
Prints one line a depth: the reference's errors, the port's, and the
port's decode logits against the reference's. Imports both packages, so
it runs where the tests run, never on the card. About a minute in all.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = {"deepseek-moe-16b": [2, 4], "rwkv6-7b": [2, 4, 8],
          "zamba2-7b": [6, 12]}
BATCH, PROMPT, STEPS, MAX_LEN = 2, 96, 4, 128
WIDTHS = dict(d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
              d_ff=512, vocab_size=4096)


def cut(cfg, n_layers: int):
    """``cfg`` at ``n_layers`` layers and `WIDTHS`, in either package
    (their configs have the same fields)."""
    kw = dict(WIDTHS, num_layers=n_layers)
    if cfg.moe is not None:
        m = cfg.moe
        kw["moe"] = dataclasses.replace(
            m, num_experts=8, top_k=2, d_ff_expert=128,
            d_ff_shared=128 if m.num_shared else 0,
            capacity_factor=8 / 2)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, head_size=32, d_state=32,
                                        lora_rank=32)
    return dataclasses.replace(cfg, **kw)


def rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def reference_run(arch: str, n_layers: int, toks):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.models import build_model, init_model_params
    from repro.models.api import init_cache

    model = build_model(cut(get_config(arch), n_layers))
    params = init_model_params(model, 0)
    full, _ = jax.jit(model.forward)(params, {"tokens": jnp.asarray(toks)})
    cache = init_cache(model, BATCH, MAX_LEN)
    _, cache = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :PROMPT])}, cache)
    decode = jax.jit(model.decode)
    steps = []
    for t in range(STEPS):
        got, cache = decode(params, {
            "tokens": jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]),
            "cache_len": jnp.full((BATCH,), PROMPT + t, jnp.int32)}, cache)
        steps.append(np.asarray(got[:, 0].astype(jnp.float32)))
    full = np.asarray(full.astype(jnp.float32))
    return params, steps, [full[:, PROMPT + t] for t in range(STEPS)]


def port_run(arch: str, n_layers: int, toks, jparams):
    import jax
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_cache, params_from_numpy

    model = build_model(cut(get_config(arch), n_layers), device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.as_tensor(toks)})
        cache = init_cache(model, BATCH, MAX_LEN, device="cpu")
        _, cache = model.prefill(params, {"tokens": torch.as_tensor(
            toks[:, :PROMPT])}, cache)
        steps = []
        for t in range(STEPS):
            got, cache = model.decode(params, {
                "tokens": torch.as_tensor(toks[:, PROMPT + t:PROMPT + t + 1]),
                "cache_len": torch.full((BATCH,), PROMPT + t)}, cache)
            steps.append(got[:, 0].float().numpy())
    return steps, [full[:, PROMPT + t].float().numpy() for t in range(STEPS)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=list(DEPTHS),
                    choices=list(DEPTHS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    for arch in args.arch:
        for n_layers in DEPTHS[arch]:
            toks = np.random.default_rng(1).integers(
                1, WIDTHS["vocab_size"], (BATCH, PROMPT + STEPS)) \
                .astype(np.int32)
            jparams, jsteps, jfull = reference_run(arch, n_layers, toks)
            tsteps, tfull = port_run(arch, n_layers, toks, jparams)
            ref = [rel_err(a, b) for a, b in zip(jsteps, jfull)]
            port = [rel_err(a, b) for a, b in zip(tsteps, tfull)]
            across = [rel_err(a, b) for a, b in zip(tsteps, jsteps)]
            print(f"{arch} {n_layers} layers (CPU, bfloat16, widths cut): "
                  f"cache vs forward, reference {min(ref):.5f}-"
                  f"{max(ref):.5f}, port {min(port):.5f}-{max(port):.5f}; "
                  f"port decode vs reference decode {min(across):.5f}-"
                  f"{max(across):.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
