"""The port's sharding rules, activation constraints, meshes and abstract
trees against the JAX package's, on the CPU.

The rules read only each mesh axis's name and size, so they are compared
on the production meshes with no devices: the reference's `spec_for`
takes a stub mesh (``axis_names`` and ``devices.shape``), the port's a
`launch.mesh.MeshShape`, and their ``PartitionSpec`` entries must be
equal, entry for entry, for every parameter, cache, optimizer-state and
input leaf of every registered config, applicable shape, strategy and
mesh. The reference's step helpers build ``NamedSharding``s; here its
module's ``NamedSharding`` and ``replicated`` are swapped for functions
that return the bare spec, so that its own code gives the specs.

The abstract trees (`axes_tree`, `abstract_params`, `abstract_cache`,
`abstract_opt_state`, `input_specs`) must equal the reference's in
shape and dtype. `constrain` leaves a tensor unchanged outside a context
and on a plain tensor, and the models' losses and greedy tokens are
bitwise the same with a context installed. On a world-size-1 gloo
``DeviceMesh`` every placement builds and each local shard equals its
parameter; the layout of a dim split over several mesh axes is held to
JAX's own index map over 8 host devices (a subprocess) through torch's
fake process group.
"""
import json
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.configs.base import input_specs as j_input_specs
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro.models.api import abstract_cache as j_abstract_cache
from repro.sharding import ctx as jctx
from repro.sharding import rules as jrules
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 input_specs, list_configs, reduced)
from repro_torch.launch.mesh import (MeshShape, make_local_mesh,
                                     make_production_mesh, mesh_axis_sizes)
from repro_torch.models import build_model, init_model_params
from repro_torch.models import layers as L
from repro_torch.models.api import abstract_cache
from repro_torch.sharding import ctx
from repro_torch.sharding.rules import (NamedSharding, Strategy,
                                        batch_sharding, placements_for,
                                        replicated, sharding_tree, spec_for)
from repro_torch.train import optim, step

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "1x1": (("data", "model"), (1, 1)),
          "2x2": (("data", "model"), (2, 2))}
STRATEGIES = ("train", "serve", "fsdp", "serve_fsdp")


def _stub(names, shape):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _items(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted key order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _items(tree[k], prefix + (k,))


def _dtype(x) -> str:
    d = x.dtype
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else str(np.dtype(d))


def assert_same_abstract(got, want):
    """Port "meta" tensors vs reference ``ShapeDtypeStruct``s, leaf for
    leaf: paths, shapes and dtypes."""
    g, w = list(_items(got)), list(_items(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.device.type == "meta", p
        assert tuple(a.shape) == tuple(b.shape), p
        assert _dtype(a) == _dtype(b), p


@pytest.fixture(scope="module")
def models():
    return {n: (build_model(get_config(n), device="cpu"),
                j_build_model(j_get_config(n))) for n in list_configs()}


@pytest.fixture(autouse=True)
def _no_installed_activation_specs():
    """Start and end every test with no activation table installed, in
    either package."""
    jctx.install(None)
    ctx.install(None)
    yield
    jctx.install(None)
    ctx.install(None)


def test_same_configs():
    assert list_configs() == j_list_configs()


def _cells(name):
    shapes = applicable_shapes(get_config(name))
    assert shapes == j_applicable_shapes(j_get_config(name))
    return shapes


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", j_list_configs())
def test_specs_match_reference(models, name, strategy, monkeypatch):
    """Every parameter, cache, optimizer-state and input leaf, every
    applicable shape and every mesh: the port's spec is the reference's
    ``PartitionSpec``, entry for entry."""
    monkeypatch.setattr(jstep, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    monkeypatch.setattr(jstep, "replicated", lambda mesh: ())
    model, jmodel = models[name]
    st, jst = Strategy(strategy), jrules.Strategy(strategy)
    p_axes = L.axes_tree(model.schema)
    p_abs = L.abstract_params(model.schema, model.cfg.param_dtype)
    jp_abs = JL.abstract_params(jmodel.schema, jmodel.cfg.param_dtype)
    for mname, (names, shape) in MESHES.items():
        mesh, jmesh = MeshShape(names, shape), _stub(names, shape)
        param_sh = sharding_tree(p_axes, p_abs, mesh, st)
        jparam_specs = {}
        for (path, axes), (_, t) in zip(L.tree_items(p_axes),
                                        L.tree_items(p_abs)):
            want = tuple(jrules.spec_for(axes, tuple(t.shape), jmesh, jst))
            assert spec_for(axes, tuple(t.shape), mesh, st) == want, \
                (mname, path)
            jparam_specs[path] = want
        assert {p: s.spec for p, s in L.tree_items(param_sh)} == \
            jparam_specs, mname
        # the optimizer state: m and a dense v as the parameters, a qint8
        # v by the first-dim heuristic, the count replicated
        jparam_tree = L.tree_from_items(jparam_specs.items())
        for ocfg, jocfg in ((optim.OptConfig(), joptim.OptConfig()),
                            (optim.OptConfig(v_dtype="qint8"),
                             joptim.OptConfig(v_dtype="qint8"))):
            got = step.opt_state_shardings(
                optim.abstract_opt_state(p_abs, ocfg), param_sh, mesh, st,
                ocfg)
            want = jstep.opt_state_shardings(
                joptim.abstract_opt_state(jp_abs, jocfg), jparam_tree, jmesh,
                jst, jocfg)
            assert {p: s.spec for p, s in _items(got)} == dict(_items(want))
        for shape_name in _cells(name):
            shp, jshp = SHAPES[shape_name], J_SHAPES[shape_name]
            B, S = shp.global_batch, shp.seq_len
            cache_axes = L.axes_tree(model.cache_schema(B, S))
            for (path, axes), (_, t) in zip(
                    L.tree_items(cache_axes),
                    L.tree_items(abstract_cache(model, B, S))):
                assert spec_for(axes, tuple(t.shape), mesh, st) == tuple(
                    jrules.spec_for(axes, tuple(t.shape), jmesh, jst)), \
                    (mname, shape_name, path)
            got = step.batch_shardings_for(input_specs(model.cfg, shp),
                                           mesh, st)
            want = jstep.batch_shardings_for(
                j_input_specs(jmodel.cfg, jshp), jmesh, jst)
            assert {p: s.spec for p, s in _items(got)} == \
                dict(_items(want)), (mname, shape_name)


@pytest.mark.parametrize("name", j_list_configs())
def test_abstract_trees_match_reference(models, name):
    model, jmodel = models[name]
    assert dict(L.tree_items(L.axes_tree(model.schema))) == \
        dict(_items(JL.axes_tree(jmodel.schema)))
    p_abs = L.abstract_params(model.schema, model.cfg.param_dtype)
    jp_abs = JL.abstract_params(jmodel.schema, jmodel.cfg.param_dtype)
    assert_same_abstract(p_abs, jp_abs)
    for ocfg, jocfg in (
            (optim.OptConfig(), joptim.OptConfig()),
            (optim.OptConfig(m_dtype=torch.bfloat16, v_dtype="qint8"),
             joptim.OptConfig(m_dtype=jax.numpy.bfloat16, v_dtype="qint8"))):
        got, want = optim.abstract_opt_state(p_abs, ocfg), \
            joptim.abstract_opt_state(jp_abs, jocfg)
        assert_same_abstract({"m": got["m"], "v": got["v"]},
                             {"m": want["m"], "v": want["v"]})
        assert tuple(got["count"].shape) == tuple(want["count"].shape)
        assert _dtype(got["count"]) == _dtype(want["count"])
    for shape_name in _cells(name):
        shp = SHAPES[shape_name]
        assert_same_abstract(
            abstract_cache(model, shp.global_batch, shp.seq_len),
            j_abstract_cache(jmodel, shp.global_batch, shp.seq_len))
        got = input_specs(model.cfg, shp)
        want = j_input_specs(jmodel.cfg, J_SHAPES[shape_name])
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert _dtype(got[k]) == _dtype(want[k]), k


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mname", list(MESHES))
def test_mesh_helpers_match_reference(mname, strategy, monkeypatch):
    """`batch_sharding`, `replicated`, the activation specs and the
    data-parallel degree."""
    monkeypatch.setattr(jrules, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    names, shape = MESHES[mname]
    mesh, jmesh = MeshShape(names, shape), _stub(names, shape)
    st, jst = Strategy(strategy), jrules.Strategy(strategy)
    assert replicated(mesh).spec == jrules.replicated(jmesh)
    for ndim in (1, 2, 3):
        for div in (True, False):
            assert batch_sharding(mesh, st, ndim=ndim,
                                  batch_divisible=div).spec == \
                jrules.batch_sharding(jmesh, jst, ndim=ndim,
                                      batch_divisible=div)
    got = ctx.make_activation_specs(mesh, strategy)
    want = jctx.make_activation_specs(AbstractMesh(shape, names), strategy)
    assert got == {k: tuple(v.spec) for k, v in want.items()}
    assert mesh_axis_sizes(mesh) == dict(zip(names, shape))
    assert step._dp_degree(mesh) == jstep._dp_degree(jmesh)


def test_production_meshes():
    for multi_pod, names, shape in ((False, ("data", "model"), (16, 16)),
                                    (True, ("pod", "data", "model"),
                                     (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert (mesh.axis_names, mesh.shape) == (names, shape)
    with pytest.raises(ValueError):
        MeshShape(("data",), (2, 2))


def test_constrain_is_a_no_op_outside_a_context_and_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert ctx.constrain(x, "btd") is x
    mesh = make_production_mesh(multi_pod=True)
    with ctx.activation_sharding(mesh, "train"):
        assert ctx._STATE is not None
        assert ctx.constrain(x, "btd") is x            # a plain tensor
        y = x[0]
        assert ctx.constrain(y, "btd") is y             # another rank
        assert ctx.constrain(x, "no such kind") is x
    assert ctx._STATE is None
    ctx.install(mesh, "fsdp")
    assert ctx._STATE[1]["btd"][0] == ("pod", "data", "model")
    ctx.install(None)
    assert ctx._STATE is None


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "deepseek-moe-16b",
                                  "whisper-medium"])
def test_models_unchanged_with_a_context_installed(name):
    """The constraints the models call change nothing on plain tensors:
    loss and greedy tokens bitwise with and without a table."""
    model = build_model(reduced(get_config(name)), device="cpu")
    params = init_model_params(model, 0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (2, 16)),
                             dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if model.cfg.is_encdec:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (2, model.cfg.enc_ctx, model.cfg.d_model)), dtype=torch.float32)

    def run():
        with torch.no_grad():
            loss, _ = model.loss(params, batch)
            logits, _ = model.forward(params, {k: v for k, v in batch.items()
                                               if k != "labels"})
        return loss, logits.argmax(-1)
    plain = run()
    with ctx.activation_sharding(make_production_mesh(), "train"):
        inside = run()
    assert torch.equal(plain[0], inside[0])
    assert torch.equal(plain[1], inside[1])


@pytest.fixture
def local_mesh():
    import torch.distributed as dist

    mesh = make_local_mesh(data=1, model=1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_local_mesh_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    """``make_local_mesh()`` asks for the cards: on a host without one
    it raises before it starts a process group, as every entry of the
    port does, and never falls back to the CPU by itself."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_local_mesh()
    assert not dist.is_initialized()


def test_local_mesh_refuses_more_ranks_than_the_world(local_mesh):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_local_mesh(data=2, model=2, device="cpu")
    assert mesh_axis_sizes(local_mesh) == {"data": 1, "model": 1}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_placements_lay_parameters_out_on_a_local_mesh(local_mesh, strategy):
    """Every parameter of reduced qwen and deepseek distributed by its
    sharding on the world-size-1 mesh: each local shard is the
    parameter."""
    from torch.distributed.tensor import distribute_tensor

    for name in ("qwen1.5-0.5b", "deepseek-moe-16b"):
        model = build_model(reduced(get_config(name)), device="cpu")
        params = init_model_params(model, 1, device="cpu")
        sh = sharding_tree(L.axes_tree(model.schema), params, local_mesh,
                           Strategy(strategy))
        for (path, p), (_, s) in zip(L.tree_items(params),
                                     L.tree_items(sh)):
            d = distribute_tensor(p, local_mesh, s.placements)
            assert torch.equal(d.to_local(), p), path
    x = torch.randn(4, 8, 16)
    with ctx.activation_sharding(local_mesh, strategy):
        d = distribute_tensor(x, local_mesh, replicated(local_mesh)
                              .placements)
        assert torch.equal(ctx.constrain(d, "btd").to_local(), x)


_JAX_LAYOUT = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
out = {}
for names, shape, spec in json.loads(os.environ["CASES"]):
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    ps = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, ps).devices_indices_map((16, 8))
    pos = {d: c for c, d in np.ndenumerate(mesh.devices)}
    out[json.dumps([names, shape, spec])] = sorted(
        [list(map(int, pos[d])), [s.start or 0 for s in sl]]
        for d, sl in idx.items())
print(json.dumps(out))
"""
LAYOUT_CASES = [
    [["pod", "data", "model"], [2, 2, 2], [["pod", "data"], "model"]],
    [["pod", "data", "model"], [2, 2, 2], [["pod", "data", "model"], None]],
    [["pod", "data", "model"], [2, 2, 2], [["data", "model"], None]],
    [["data", "model"], [2, 4], [["data", "model"], None]],
    [["data", "model"], [2, 4], ["model", "data"]],
]


def test_grouped_dims_lay_out_as_jax_groups():
    """A dim split over several mesh axes: DTensor's placements (one
    ``Shard(d)`` per axis, in mesh order) give every rank the block that
    JAX's ``PartitionSpec`` group gives the device at the same mesh
    position."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    proc = subprocess.run(
        [sys.executable, "-c", _JAX_LAYOUT], capture_output=True, text=True,
        timeout=300, env={**os.environ, "CASES": json.dumps(LAYOUT_CASES)})
    assert proc.returncode == 0, proc.stderr
    jax_maps = json.loads(proc.stdout.strip().splitlines()[-1])
    for case in LAYOUT_CASES:
        names, shape, spec = case
        spec_t = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        n = int(np.prod(shape))
        got = []
        for rank in range(n):
            dist.init_process_group("fake", rank=rank, world_size=n,
                                    store=FakeStore())
            try:
                mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                                  mesh_dim_names=tuple(names))
                _, offset = compute_local_shape_and_global_offset(
                    (16, 8), mesh, placements_for(spec_t, mesh))
                got.append([list(mesh.get_coordinate()), list(offset)])
            finally:
                dist.destroy_process_group()
        assert sorted(got) == jax_maps[json.dumps(case)], case


def test_group_out_of_mesh_order_raises():
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="order"):
        placements_for((("model", "data"), None), mesh)
    assert isinstance(NamedSharding(mesh, ()).spec, tuple)


def test_jax_partition_spec_entries_are_tuples():
    """What the comparisons above rely on: a ``PartitionSpec`` is the
    tuple of its entries."""
    assert tuple(PartitionSpec(("pod", "data"), None)) == \
        (("pod", "data"), None)
