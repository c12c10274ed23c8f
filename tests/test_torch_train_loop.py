"""The port's training loop and CLI (`train/loop.py`, `launch/train.py`):
five steps of reduced qwen1.5-0.5b against the reference's loop on the
CPU, and the port's counterparts of `tests/test_system.py`'s two
training tests (loss decreases and a resumed run continues; two
same-seed runs agree), made stricter: the resumed run equals the
uninterrupted one bitwise.

The sizes are `tests/test_system.py`'s ``tiny_setup``: reduced qwen with
a 64-token vocabulary, 4 rows of 64 tokens, structure 7, lr 3e-3 with 5
warmup steps of 60. The reference's `make_train_step` builds a mesh that
jax 0.9 refuses (ROADMAP C.2), so its side here is its own
``value_and_grad(model.loss)`` and `adamw_update` in a hand-built
`StepBundle` driven by its `train.loop.train`. Both compute in float32:
each step's loss is held to rtol 1e-5.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import build_model as j_build_model
from repro.models import init_model_params as j_init_model_params
from repro.sharding import ctx as jctx
from repro.train import loop as j_loop
from repro.train import optim as j_optim
from repro.train.step import StepBundle as JStepBundle
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.train import optim
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import init_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _no_installed_activation_specs():
    """The reference's train-step factory installs activation sharding
    specs for the whole process (`repro.sharding.ctx.install`), so a test
    of another file that built one leaves them set in this worker, and
    the reference's models then constrain to a mesh no test here entered.
    Start from none, as a fresh process does."""
    jctx.install(None)


ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(atol=0.0, rtol=1e-5)
VOCAB, SEQ, BATCH = 64, 64, 4
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=60)
BATCH_TREE = {"tokens": ((BATCH, SEQ), torch.int32),
              "labels": ((BATCH, SEQ), torch.int32)}


@pytest.fixture(scope="module")
def tiny():
    """(port model, its optimizer config, data config, step bundle)."""
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              vocab_size=VOCAB)
    model = build_model(cfg, device="cpu")
    oc = optim.OptConfig(**OPT)
    dc = DataConfig(vocab_size=VOCAB, seq_len=SEQ, global_batch=BATCH,
                    structure=7)
    return model, oc, dc, make_train_step(model, oc, BATCH_TREE,
                                          device="cpu")


def _same_state(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
               for (_, x), (_, y) in zip(L.tree_items(a), L.tree_items(b)))


def test_five_steps_match_the_reference(tiny):
    model, oc, dc, bundle = tiny
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen1.5-0.5b")),
                               vocab_size=VOCAB)
    jm = j_build_model(jcfg)
    tree = jax.tree.map(np.asarray, j_init_model_params(jm, 0))
    joc = j_optim.OptConfig(**OPT)

    @jax.jit
    def j_step(state, batch):
        (_, metrics), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            state["params"], batch)
        params, opt, stats = j_optim.adamw_update(grads, state["opt"],
                                                  state["params"], joc)
        return {"params": params, "opt": opt, "step": state["step"] + 1}, \
            {**metrics, **stats, "step": state["step"] + 1}

    jp = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jp, "opt": j_optim.init_opt_state(jp, joc),
              "step": jnp.zeros((), jnp.int32)}
    jbundle = JStepBundle(step_fn=j_step, abstract_state=None,
                          state_shardings=None, batch_shardings=None,
                          mesh=None)
    jdc = JDataConfig(vocab_size=VOCAB, seq_len=SEQ, global_batch=BATCH,
                      structure=7)
    _, want = j_loop.train(jm, jbundle, jdc, j_loop.LoopConfig(
        n_steps=5, log_every=1), jstate, log=None)

    params = params_from_numpy(model, tree, device="cpu")
    state = {"params": params, "opt": optim.init_opt_state(params, oc),
             "step": torch.zeros((), dtype=torch.int32)}
    _, got = train(model, bundle, dc, LoopConfig(n_steps=5, log_every=1),
                   state, device="cpu", log=None)
    assert [h["step"] for h in got] == [h["step"] for h in want] == \
        [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], **LOSS_TOL)
        assert g["aux"] == w["aux"] == 0.0
    assert got[-1]["loss"] < got[0]["loss"]


def test_train_loss_decreases_and_resumes_bitwise(tiny, tmp_path):
    """20 steps without a break against 10 steps, an async checkpoint,
    and a second call that resumes from it (state None) to step 20: the
    loss falls, and the resumed half's history and final state equal
    the uninterrupted run's bitwise."""
    model, oc, dc, bundle = tiny
    whole, hist = train(model, bundle, dc, LoopConfig(n_steps=20,
                                                      log_every=5),
                        init_state(model, oc, 0, device="cpu"),
                        device="cpu", log=None)
    assert hist[-1]["loss"] < hist[0]["loss"]
    lc = LoopConfig(n_steps=10, ckpt_every=10, ckpt_dir=str(tmp_path),
                    log_every=5, async_ckpt=True)
    train(model, bundle, dc, lc, init_state(model, oc, 0, device="cpu"),
          device="cpu", log=None)
    assert ckpt.latest_step(tmp_path) == 10
    logs = []
    resumed, hist2 = train(model, bundle, dc, dataclasses.replace(
        lc, n_steps=20), None, device="cpu", log=logs.append)
    assert logs[0] == "[train] resumed from step 10"
    assert [h["step"] for h in hist2] == [15, 20]
    for a, b in zip(hist2, hist[2:]):
        assert {k: v for k, v in a.items() if k != "time_s"} == \
            {k: v for k, v in b.items() if k != "time_s"}
    assert _same_state(resumed, whole)
    assert ckpt.latest_step(tmp_path) == 20


def test_determinism_same_seed(tiny):
    model, oc, dc, bundle = tiny
    losses = []
    for _ in range(2):
        _, hist = train(model, bundle, dc, LoopConfig(n_steps=5,
                                                      log_every=1),
                        init_state(model, oc, 3, device="cpu"),
                        device="cpu", log=None)
        losses.append([h["loss"] for h in hist])
    assert losses[0] == losses[1]
    _, other = train(model, bundle, dc, LoopConfig(n_steps=1, log_every=1),
                     init_state(model, oc, 4, device="cpu"), device="cpu",
                     log=None)
    assert other[0]["loss"] != losses[0][0]


def test_train_needs_a_state_or_a_checkpoint(tiny, tmp_path):
    model, oc, dc, bundle = tiny
    with pytest.raises(ValueError, match="no initial state"):
        train(model, bundle, dc, LoopConfig(n_steps=1, ckpt_every=1,
                                            ckpt_dir=str(tmp_path)),
              None, device="cpu", log=None)


CLI_CHECK = (
    "import runpy, sys\n"
    "sys.argv = ['train'] + sys.argv[1:]\n"
    "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
    "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
    "('jax', 'jaxlib', 'repro'))\n"
    "print('imported:', bad)\n")


def test_cli_trains_on_the_cpu_without_jax(tmp_path):
    """`python -m repro_torch.launch.train --reduced --device cpu --steps
    3` in a fresh interpreter: three steps logged, no jax and nothing of
    the JAX package imported; with checkpoints (at 2 x 32 tokens), a
    second run resumes."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}

    def run(steps, *extra):
        proc = subprocess.run(
            [sys.executable, "-c", CLI_CHECK, "--reduced", "--device", "cpu",
             "--steps", str(steps), *extra],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.splitlines()

    lines = run(3)
    assert [ln.split()[2] for ln in lines[:3]] == ["1", "2", "3"]
    assert lines[-1] == "imported: []"
    ck = ("--seq", "32", "--batch", "2", "--ckpt-every", "2",
          "--ckpt-dir", str(tmp_path / "ck"))
    run(2, *ck)
    assert ckpt.latest_step(tmp_path / "ck") == 2
    assert "[train] resumed from step 2" in run(4, *ck)
    assert ckpt.latest_step(tmp_path / "ck") == 4


def test_cli_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.launch import train as cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--reduced", "--steps", "1"])
    cfg = reduced(get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(build_model(cfg, device="cpu"), optim.OptConfig(),
                        BATCH_TREE)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(build_model(cfg, device="cpu"), optim.OptConfig())
