"""The port's GPipe schedule (`repro_torch.sharding.pipeline`) against the
JAX package's, on the CPU.

The problem is `tests/test_pipeline.py`'s: 8 layers of tanh(h @ w) at
d 16 over 4 stages, a batch of 8 in 4 microbatches, weights and input
from numpy seed 0. The reference runs its `gpipe_apply` on a (pipe 4,
data 2) mesh of 8 forced host devices in a subprocess that builds the
mesh itself with Auto axes (ROADMAP C.2: jax's default Explicit axes
refuse its shard_map). The port runs one gloo rank a stage, each in its
own process, over a ``FileStore`` in the test's directory (no port, no
network): forward within 1e-5 and the gradient within 1e-4 relative,
the reference's own bounds against its sequential loop. With one stage
both packages run in this process.

`run_ranks` (used by the other multi-rank tests too) starts the ranks.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sharding.pipeline import bubble_fraction as j_bubble_fraction
from repro.sharding.pipeline import gpipe_apply as j_gpipe_apply
from repro_torch.sharding.pipeline import bubble_fraction, gpipe_apply

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240

_RANK = """\
import os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
    rank=rank, world_size=world)
try:
{body}
finally:
    dist.destroy_process_group()
"""


def run_ranks(tmp_path, world: int, body: str, timeout: int = RANK_TIMEOUT):
    """Run ``body`` (Python, indented into a ``try``; it sees ``rank``,
    ``world``, ``out_dir``, numpy, torch and ``dist`` with the gloo
    group up) in ``world`` processes, one a rank, and return what each
    saved to ``out_dir/rank{r}.pt`` (``save(obj)`` there)."""
    out_dir = tmp_path / f"ranks{world}"
    out_dir.mkdir()
    body = ("    def save(obj):\n"
            "        torch.save(obj, os.path.join(out_dir, f'rank{rank}.pt'))\n"
            + textwrap.indent(textwrap.dedent(body), "    "))
    script = out_dir / "rank.py"
    script.write_text(_RANK.format(body=body))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


def reference_subprocess(code: str, devices: int, timeout: int = 600):
    """Run ``code`` in a fresh interpreter with ``devices`` forced host
    devices; returns the JSON object it prints last."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


L_LAYERS, D, STAGES, MB = 8, 16, 4, 4


def _problem():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(L_LAYERS, D, D)).astype(np.float32) * 0.3
    x = rng.normal(size=(8, D)).astype(np.float32)
    return w, x


_REF_4x2 = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro.sharding.pipeline import gpipe_apply
rng = np.random.default_rng(0)
L, d = 8, 16
W = jnp.asarray(rng.normal(size=(L, d, d)).astype(np.float32) * 0.3)
x = jnp.asarray(rng.normal(size=(8, d)).astype(np.float32))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("pipe", "data"),
            axis_types=(AxisType.Auto,) * 2)
layer = lambda w, h: jnp.tanh(h @ w)
def loss(Wf):
    return jnp.sum(gpipe_apply(layer, Wf.reshape(4, 2, d, d), x, mesh=mesh,
                               microbatches=4) ** 2)
with mesh:
    out = gpipe_apply(layer, W.reshape(4, 2, d, d), x, mesh=mesh,
                      microbatches=4)
    g = jax.grad(loss)(W)
print(json.dumps({"out": np.asarray(out).tolist(),
                  "grad": np.asarray(g).tolist()}))
"""

_PORT_RANK = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.sharding.pipeline import gpipe_apply
mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("pipe", "data"))
rng = np.random.default_rng(0)
W = torch.tensor(rng.normal(size=(8, 16, 16)).astype(np.float32) * 0.3,
                 requires_grad=True)
x = torch.tensor(rng.normal(size=(8, 16)).astype(np.float32))
y = gpipe_apply(lambda w, h: torch.tanh(h @ w),
                W.reshape(world, 8 // world, 16, 16), x, mesh=mesh,
                microbatches=4)
(y ** 2).sum().backward()
g = W.grad.clone()
dist.all_reduce(g)         # each stage holds its own layers' gradient
save({"out": y.detach(), "grad": g})
"""


@pytest.mark.parametrize("stages,microbatches", [(1, 8), (4, 4), (8, 4),
                                                 (2, 16), (3, 5)])
def test_bubble_fraction_matches_reference(stages, microbatches):
    assert bubble_fraction(stages, microbatches) == \
        j_bubble_fraction(stages, microbatches)


@pytest.fixture
def one_rank():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("pipe", "data"))
    finally:
        dist.destroy_process_group()


def test_one_stage_matches_reference(one_rank):
    """One stage runs the stack on its microbatches with no hand-off:
    forward and gradient against the reference's on a one-device mesh."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(4, 8, 8)) * 0.3).astype(np.float32)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    jmesh = jax.make_mesh((1,), ("pipe",))

    def jloss(wf):
        return jnp.sum(j_gpipe_apply(lambda p, h: jnp.tanh(h @ p),
                                     wf.reshape(1, 4, 8, 8), jnp.asarray(x),
                                     mesh=jmesh, microbatches=2) ** 2)
    with jmesh:
        want = j_gpipe_apply(lambda p, h: jnp.tanh(h @ p),
                             jnp.asarray(w).reshape(1, 4, 8, 8),
                             jnp.asarray(x), mesh=jmesh, microbatches=2)
        jg = jax.grad(jloss)(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    got = gpipe_apply(lambda p, h: torch.tanh(h @ p), wt.reshape(1, 4, 8, 8),
                      torch.tensor(x), mesh=one_rank, microbatches=2)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


def test_one_stage_refuses_a_batch_that_microbatches_do_not_divide(
        one_rank):
    with pytest.raises(ValueError, match="microbatches"):
        gpipe_apply(lambda p, h: h, torch.zeros(1, 2, 3, 3),
                    torch.zeros(6, 3), mesh=one_rank, microbatches=4)


def test_four_stages_match_reference(tmp_path):
    """(pipe 4, data 1) on 4 gloo ranks against the reference's (4, 2)
    run of the same problem: forward <= 1e-5, gradient <= 1e-4 relative;
    every stage holds the same result."""
    want = reference_subprocess(_REF_4x2, 8)
    outs = run_ranks(tmp_path, STAGES, _PORT_RANK)
    ref_out, ref_g = np.asarray(want["out"]), np.asarray(want["grad"])
    for r, o in enumerate(outs):
        assert float(np.abs(o["out"].numpy() - ref_out).max()) < 1e-5, r
        gerr = float(np.abs(o["grad"].numpy() - ref_g).max()
                     / (np.abs(ref_g).max() + 1e-9))
        assert gerr < 1e-4, (r, gerr)
        assert torch.equal(o["out"], outs[0]["out"])
    # and the sequential loop of the same problem
    w, x = _problem()
    h = x
    for i in range(L_LAYERS):
        h = np.tanh(h @ w[i])
    np.testing.assert_allclose(outs[0]["out"].numpy(), h, atol=1e-5)


def test_a_schedule_that_skips_one_hand_off_is_caught(tmp_path):
    """What the four-stage check reads from a schedule whose hand-off at
    one tick delivers zeros: far outside its bound."""
    body = _PORT_RANK.replace(
        "from repro_torch.sharding.pipeline import gpipe_apply",
        "from repro_torch.sharding import pipeline as pp\n"
        "gpipe_apply = pp.gpipe_apply\n"
        "_shift, calls = pp._RingShift.apply, []\n"
        "def skip(x, *a):\n"
        "    calls.append(1)\n"
        "    y = _shift(x, *a)\n"
        "    return y * 0 if len(calls) == 3 else y\n"
        "pp._RingShift.apply = skip")
    outs = run_ranks(tmp_path, STAGES, body)
    w, x = _problem()
    h = x
    for i in range(L_LAYERS):
        h = np.tanh(h @ w[i])
    assert float(np.abs(outs[0]["out"].numpy() - h).max()) > 1e-2
