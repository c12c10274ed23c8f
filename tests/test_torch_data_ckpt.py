"""The port's data pipeline (`data/pipeline.py`) and checkpoints
(`checkpoint/ckpt.py`) against the JAX package's, on the CPU.

Batches must equal the reference's bit for bit for every (seed, step,
host_id, num_hosts), from the synthetic source and from a memmap token
file. Checkpoints keep the reference's layout, so each package restores
the other's: float32, int32 and int8 leaves bitwise, both ways. The
port's own round trip is bitwise too, bfloat16 included (stored as its
raw 16 bits: numpy has no bfloat16).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import ShardedLoader as JShardedLoader
from repro.models import build_model as j_build_model
from repro.sharding import ctx as jctx
from repro.train import optim as j_optim
from repro.train.step import init_state as j_init_state
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.train import optim
from repro_torch.train.step import (abstract_state, init_state,
                                    make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _no_installed_activation_specs():
    """The reference's train-step factory installs activation sharding
    specs for the whole process (`repro.sharding.ctx.install`), so a test
    of another file that built one leaves them set in this worker, and
    the reference's models then constrain to a mesh no test here entered.
    Start from none, as a fresh process does."""
    jctx.install(None)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

SPLITS = [(1, 0), (2, 0), (2, 1), (4, 3)]     # (num_hosts, host_id)


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("vocab,structure", [(256, 97), (151936, 7),
                                             (64, 1)])
def test_synthetic_batches_equal_the_reference(seed, vocab, structure):
    cfg = dict(vocab_size=vocab, seq_len=33, global_batch=8, seed=seed,
               structure=structure)
    for hosts, host in SPLITS:
        mine = ShardedLoader(DataConfig(**cfg), host, hosts)
        ref = JShardedLoader(JDataConfig(**cfg), host, hosts)
        for step in (0, 1, 7, 1000, 2 ** 40):
            got, want = mine.batch(step), ref.batch(step)
            assert got.keys() == want.keys() == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


def test_host_shards_tile_the_global_batch():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    whole = ShardedLoader(cfg).batch(5)["tokens"]
    parts = [ShardedLoader(cfg, h, 4).batch(5)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    first = next(iter(ShardedLoader(cfg)))
    np.testing.assert_array_equal(first["tokens"],
                                  ShardedLoader(cfg).batch(0)["tokens"])
    np.testing.assert_array_equal(first["labels"][:, :-1],
                                  first["tokens"][:, 1:])
    with pytest.raises(ValueError, match="split"):
        ShardedLoader(cfg, 0, 3)


def test_memmap_batches_equal_the_reference(tmp_path):
    rng = np.random.default_rng(27)
    path = tmp_path / "tokens.bin"
    rng.integers(0, 50000, 10000).astype(np.uint16).tofile(path)
    for seed in (0, 9):
        cfg = dict(vocab_size=50000, seq_len=48, global_batch=4, seed=seed,
                   source="memmap", path=str(path))
        for hosts, host in [(1, 0), (2, 1)]:
            mine = ShardedLoader(DataConfig(**cfg), host, hosts)
            ref = JShardedLoader(JDataConfig(**cfg), host, hosts)
            for step in (0, 3, 99):
                got, want = mine.batch(step), ref.batch(step)
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        ShardedLoader(DataConfig(vocab_size=8, seq_len=4, global_batch=1,
                                 source="memmap",
                                 path=str(tmp_path / "none.bin")))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _equal_trees(got, want):
    """Torch tree ``got`` against a tree ``want`` of tensors or arrays:
    the same paths, dtypes and bits."""
    g, w = dict(L.tree_items(got)), dict(L.tree_items(want))
    assert g.keys() == w.keys()
    for k, t in g.items():
        ref = w[k]
        if isinstance(ref, torch.Tensor):
            assert t.dtype == ref.dtype and torch.equal(t, ref), k
        else:
            ref = np.asarray(ref)
            assert str(t.dtype).split(".")[-1] == ref.dtype.name, k
            np.testing.assert_array_equal(t.numpy(), ref)


def _trained_state(v_dtype, m_dtype=torch.float32):
    """Reduced qwen's state after one step (nonzero moments)."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    model = build_model(cfg, device="cpu")
    oc = optim.OptConfig(m_dtype=m_dtype, v_dtype=v_dtype)
    state = init_state(model, oc, 0, device="cpu")
    b = ShardedLoader(DataConfig(cfg.vocab_size, 16, 2)).batch(0)
    tree = {k: (v.shape, torch.int32) for k, v in b.items()}
    state, _ = make_train_step(model, oc, tree, device="cpu").step_fn(state, b)
    return model, oc, state


@pytest.mark.parametrize("m_dtype,v_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, "qint8"),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("async_write", [False, True])
def test_round_trip_bitwise(m_dtype, v_dtype, async_write, tmp_path):
    model, oc, state = _trained_state(v_dtype, m_dtype)
    d, thread = ckpt.save(state, 1, str(tmp_path), async_write=async_write)
    assert (thread is not None) == async_write
    if thread is not None:
        thread.join()
    assert d == tmp_path / "step_00000001" and not list(
        tmp_path.glob("*.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    back = ckpt.restore(str(tmp_path), 1, abstract_state(model, oc),
                        device="cpu")
    _equal_trees(back, state)
    meta = json.loads((d / "meta.json").read_text())
    assert meta["step"] == 1
    leaf = meta["leaves"]["opt/m/embed/embedding"]
    assert leaf["file"] == "opt.m.embed.embedding.npy"
    if m_dtype == torch.bfloat16:
        assert leaf["dtype"] == "bfloat16"
        assert np.load(d / leaf["file"]).dtype == np.uint16
    if v_dtype == "qint8":
        assert meta["leaves"]["opt/v/embed/embedding/q"]["dtype"] == "int8"


def test_latest_step_ignores_partial_writes(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    t = {"a": torch.arange(3, dtype=torch.int32)}
    ckpt.save(t, 3, str(tmp_path))
    ckpt.save(t, 12, str(tmp_path))
    (tmp_path / "step_00000020.tmp").mkdir()
    (tmp_path / "step_00000030").mkdir()           # no meta.json: partial
    assert ckpt.latest_step(str(tmp_path)) == 12
    # the template's nesting decides what is read; a list keeps its type
    t2 = {"a": torch.zeros(3), "b": [torch.ones(2), torch.ones(())]}
    ckpt.save(t2, 13, str(tmp_path))
    back = ckpt.restore(str(tmp_path), 13, {"b": [0, 0]}, device="cpu")
    assert isinstance(back["b"], list) and back.keys() == {"b"}
    assert torch.equal(back["b"][1], torch.ones(()))


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    ckpt.save({"a": torch.zeros(2)}, 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore(str(tmp_path), 1, {"a": None})


def _reference_pair():
    """(reference model, its qint8 optimizer config, port model, the
    port's config) for reduced qwen."""
    jm = j_build_model(j_reduced(j_get_config("qwen1.5-0.5b")))
    joc = j_optim.OptConfig(v_dtype="qint8")
    tm = build_model(reduced(get_config("qwen1.5-0.5b")), device="cpu")
    return jm, joc, tm, optim.OptConfig(v_dtype="qint8")


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's train state (float32 parameters and m, a qint8 v of
    int8 codes and float32 scales, int32 counts), written by its `save`
    and read by the port's `restore`, bitwise."""
    jm, joc, tm, oc = _reference_pair()
    jstate = j_init_state(jm, joc, 7)
    jstate = dict(jstate, step=jnp.asarray(42, jnp.int32))
    j_ckpt.save(jstate, 42, str(tmp_path))
    back = ckpt.restore(str(tmp_path), 42, abstract_state(tm, oc),
                        device="cpu")
    _equal_trees(back, jax.tree.map(np.asarray, jstate))
    assert int(back["step"]) == 42


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jm, joc, tm, oc = _reference_pair()
    _, _, state = _trained_state("qint8")
    ckpt.save(state, 1, str(tmp_path))
    template = jax.eval_shape(lambda: j_init_state(jm, joc, 0))
    back = j_ckpt.restore(str(tmp_path), 1, template)
    want = dict(L.tree_items(state))
    got = dict(L.tree_items(jax.tree.map(np.asarray, back)))
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert a.dtype.name == str(want[k].dtype).split(".")[-1], k
        np.testing.assert_array_equal(a, want[k].detach().numpy())
    assert {a.dtype.name for a in got.values()} == {"float32", "int32",
                                                    "int8"}


def test_restored_state_trains_on(tmp_path):
    """A restored state takes the next step as the one kept in memory."""
    model, oc, state = _trained_state(torch.float32)
    ckpt.save(state, 1, str(tmp_path))
    back = ckpt.restore(str(tmp_path), 1, abstract_state(model, oc),
                        device="cpu")
    b = ShardedLoader(DataConfig(model.cfg.vocab_size, 16, 2)).batch(1)
    tree = {k: (v.shape, torch.int32) for k, v in b.items()}
    step = make_train_step(model, oc, tree, device="cpu").step_fn
    _, m1 = step(state, b)
    _, m2 = step(back, b)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    _equal_trees(back, state)
