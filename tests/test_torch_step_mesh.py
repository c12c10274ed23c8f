"""The port's steps over a mesh (`train/step.py` with ``mesh=``,
`serve/step.py`) against its one-device steps, on gloo ranks on the CPU,
and rwkv6's decode against its forward (ROADMAP C.8).

The train step: reduced qwen1.5-0.5b (float32), parameters from the
port's seed 0 on every rank, a numpy batch of 4 x 16, on a (data 2) and
a (data 1, model 2) mesh: loss and gradient norm within
`test_torch_train.LOSS_TOL`, the gradient tree within ``GRAD_TOL`` and
the update within ``STEP_UPDATE_TOL`` of the one-device step's (the same
bounds the port is held to against the reference). The serve step:
reduced qwen's prefill and decode on a (1, 2) mesh through
`make_serve_step` (its kv heads split) and reduced starcoder2's on
(1, 4) (its K and V projected on each rank's positions, each rank's
kv heads moved to it by an all-to-all, its cache's sequence split in
the decode), and reduced h2o's on (1, 4) with a window of 4 (the same
split, the prefill's ring written from the heads moved back to the
sequence split, the decodes wrapping round it) against the one-device
prefill and decode (the mesh decodes from the one-device prefill's
cache); reduced qwen2-vl's prefill into a cache as long as its prompt on
(1, 4), each rank writing its own rows; the sequence-split prefills of
reduced h2o and starcoder2 against the reference's serve prefill over
the same (1, 4) mesh of forced host devices; on a one-rank mesh its
prefill and decode are bitwise ``model.prefill`` / ``model.decode``.

C.8: per layer and decode step, rwkv6's state leaves after prefill +
decode against those of a prefill over the extended sequence, and the
readings of `tools/cache_vs_forward_reference.py` for both packages,
pinned (see ROADMAP C.8: both packages' float32 states agree to an ulp;
what differs is a bfloat16 rounding of the step's WKV output, in both
packages alike).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model, init_cache, init_model_params
from repro_torch.models import layers as L
from repro_torch.serve.step import make_serve_step
from repro_torch.sharding.rules import distribute_tree
from repro_torch.train import optim
from repro_torch.train.step import init_state, make_train_step
from test_torch_gpipe import run_ranks
from test_torch_train import (GRAD_TOL, LOSS_TOL, OPT, STEP_UPDATE_TOL,
                              _rel)

ROOT = Path(__file__).resolve().parents[1]

_TRAIN_RANK = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models.layers import tree_items
from repro_torch.sharding.rules import Strategy
from repro_torch.train import optim
from repro_torch.train.step import (distribute_state, init_state,
                                    make_train_step, mesh_context)
from torch.distributed.tensor import distribute_tensor
shape = {shape}
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(reduced(get_config("{arch}")), **{over})
model = build_model(cfg, device="cpu")
oc = optim.OptConfig(**{opt})
toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17))
batch = {{"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32)}}
bundle = make_train_step(model, oc, {{k: (v.shape, torch.int32)
                                     for k, v in batch.items()}},
                         device="cpu", mesh=mesh)
st = distribute_state(init_state(model, oc, 0, device="cpu"), bundle)
leaves = [t.requires_grad_() for _, t in tree_items(st["params"])]
tb = {{k: distribute_tensor(torch.as_tensor(v), mesh,
                           bundle.batch_shardings[k].placements,
                           src_data_rank=None) for k, v in batch.items()}}
with mesh_context(mesh, Strategy("train")):
    loss, _ = model.loss(st["params"], tb)
    grads = torch.autograd.grad(loss, leaves)
grads = [g.full_tensor() for g in grads]
st = distribute_state(init_state(model, oc, 0, device="cpu"), bundle)
st, met = bundle.step_fn(st, batch)
save({{"grads": grads, "metrics": {{k: float(v) for k, v in met.items()}},
      "params": [t.full_tensor().detach()
                 for _, t in tree_items(st["params"])]}})
"""


def _one_device_train(arch, over):
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    model = build_model(cfg, device="cpu")
    oc = optim.OptConfig(**OPT)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    st = init_state(model, oc, 0, device="cpu")
    leaves = [t.requires_grad_() for _, t in L.tree_items(st["params"])]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    grads = torch.autograd.grad(model.loss(st["params"], tb)[0], leaves)
    old = [t.detach().clone() for t in leaves]
    bundle = make_train_step(model, oc, {k: (v.shape, torch.int32)
                                         for k, v in batch.items()},
                             device="cpu")
    st, met = bundle.step_fn(init_state(model, oc, 0, device="cpu"), batch)
    return (grads, {k: float(v) for k, v in met.items()}, old,
            [t.detach() for _, t in L.tree_items(st["params"])])


# qwen; rwkv6 and zamba2, whose scans, token shifts, mixed streams and
# convolutions run on each rank's shards over a mesh (zamba2's two
# projections too); deepseek-moe, whose combine product does (its sum
# over the experts a partial one); qwen with a vocabulary of 255, which
# "model" does not divide: its tied head runs on uneven chunks of the
# vocabulary and the loss reads each rank's offset into it
TRAIN_CASES = [pytest.param(arch, shape, {}, id=f"{tag}{sid}")
               for arch, tag in (("qwen1.5-0.5b", ""), ("rwkv6-7b", "rwkv6_"),
                                 ("zamba2-7b", "zamba2_"),
                                 ("deepseek-moe-16b", "moe_"))
               for shape, sid in (((2, 1), "data2"),
                                  ((1, 2), "data1_model2"))] + [
    pytest.param("qwen1.5-0.5b", (2, 2), {"vocab_size": 255},
                 id="vocab255_data2_model2")]


@pytest.mark.parametrize("arch,shape,over", TRAIN_CASES)
def test_train_step_over_a_mesh_matches_one_device(tmp_path, arch, shape,
                                                   over):
    grads, met, old, new = _one_device_train(arch, over)
    got = run_ranks(tmp_path, shape[0] * shape[1],
                    _TRAIN_RANK.format(arch=arch, shape=shape, opt=OPT,
                                       over=over))
    for r, g in enumerate(got):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g["metrics"][k], met[k], **LOSS_TOL)
        assert g["metrics"]["step"] == met["step"] == 1
        assert _rel([t.numpy() for t in g["grads"]],
                    [t.numpy() for t in grads]) <= GRAD_TOL, r
        assert _rel([a.numpy() - b.numpy() for a, b in zip(g["params"], old)],
                    [a.numpy() - b.numpy() for a, b in zip(new, old)]) \
            <= STEP_UPDATE_TOL, r


# the qint8 second moment over a mesh: llama4 cut to 6 layers, whose 3
# stacked repeats do not divide "data" while the codes' rows (the
# first-dim heuristic) do; the clip at 1e9 keeps the gradients' scale at
# exactly 1, so that the update is elementwise and must be bitwise
Q8_ARCH, Q8_LAYERS, Q8_CLIP = "llama4-maverick-400b-a17b", 6, 1e9

_Q8_RANK = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models.layers import tree_items
from repro_torch.sharding.rules import distribute_tree
from repro_torch.train import optim
from repro_torch.train.step import distribute_state, make_train_step
mesh = init_device_mesh("cpu", {shape}, mesh_dim_names=("data", "model"))
ins = torch.load(os.path.join(out_dir, "..", "q8_in.pt"))
cfg = dataclasses.replace(reduced(get_config("{arch}")), num_layers={layers})
model = build_model(cfg, device="cpu")
oc = optim.OptConfig(m_dtype=torch.bfloat16, v_dtype="qint8",
                     grad_clip={clip})
tree = {{k: ((4, 16), torch.int32) for k in ("tokens", "labels")}}
bundle = make_train_step(model, oc, tree, device="cpu", mesh=mesh)
st = distribute_state(ins["state"], bundle)
grads = distribute_tree(ins["grads"], bundle.state_shardings["params"])
optim.adamw_update(grads, st["opt"], st["params"], oc)
save({{k: [t.full_tensor() for _, t in tree_items(tree_)]
       for k, tree_ in (("v", st["opt"]["v"]), ("m", st["opt"]["m"]),
                        ("params", st["params"]))}}
     | {{"split": [str(t.placements) for _, t in
                   tree_items(st["opt"]["v"])]}})
"""


def _q8_grads(params, seed: int):
    g = torch.Generator().manual_seed(seed)
    return L.tree_map(lambda p: torch.randn(p.shape, generator=g) * 1e-2,
                      params)


def test_qint8_adamw_step_over_a_mesh_is_bitwise_one_device(tmp_path):
    """A reduced qint8 AdamW step: the codes, the scales (so the decoded
    v), m and the parameters over a (2, 2) mesh are bitwise the
    one-device step's, the codes' rows split over "data" where the
    parameter's leading dim is not."""
    import dataclasses

    cfg = dataclasses.replace(reduced(get_config(Q8_ARCH)),
                              num_layers=Q8_LAYERS)
    model = build_model(cfg, device="cpu")
    oc = optim.OptConfig(m_dtype=torch.bfloat16, v_dtype="qint8",
                         grad_clip=Q8_CLIP)
    st = init_state(model, oc, 0, device="cpu")
    optim.adamw_update(_q8_grads(st["params"], 1), st["opt"], st["params"],
                       oc)
    grads = _q8_grads(st["params"], 2)
    torch.save({"state": st, "grads": grads}, tmp_path / "q8_in.pt")
    optim.adamw_update(grads, st["opt"], st["params"], oc)
    want = {k: [t for _, t in L.tree_items(tree)]
            for k, tree in (("v", st["opt"]["v"]), ("m", st["opt"]["m"]),
                            ("params", st["params"]))}
    got = run_ranks(tmp_path, 4, _Q8_RANK.format(
        shape=(2, 2), arch=Q8_ARCH, layers=Q8_LAYERS, clip=Q8_CLIP))
    leading = [t.shape[0] for _, t in L.tree_items(st["params"])
               if t.dim() > 2]
    assert any(n % 2 for n in leading)
    for r, g in enumerate(got):
        assert any("Shard(dim=0)" in s for s in g["split"]), g["split"]
        for k in ("v", "m", "params"):
            assert len(g[k]) == len(want[k])
            for a, b in zip(g[k], want[k]):
                assert torch.equal(a, b), (r, k)


_SERVE_RANK = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models.layers import tree_items
from repro_torch.serve.step import make_serve_step
from repro_torch.sharding.rules import distribute_tree
import dataclasses
mesh = init_device_mesh("cpu", {shape}, mesh_dim_names=("data", "model"))
model = build_model(dataclasses.replace(reduced(get_config("{arch}")),
                                        **{over}), device="cpu")
ins = torch.load(os.path.join(out_dir, "..", "serve_in.pt"))
meta = {{"tokens": torch.empty({batch}, 1, dtype=torch.int32,
                             device="meta"),
        "cache_len": torch.empty((), dtype=torch.int32, device="meta")}}
bundle = make_serve_step(model, mesh, meta, batch_size={batch}, max_len=32)
params = distribute_tree(ins["params"], bundle.param_shardings)
with torch.no_grad():
    first, fresh = bundle.prefill_fn(
        params, distribute_tree({{"tokens": ins["prompt"]}},
                                bundle.batch_shardings),
        distribute_tree(ins["empty"], bundle.cache_shardings))
cache = distribute_tree(ins["cache"], bundle.cache_shardings)
logits = []
with torch.no_grad():
    for t, tok in enumerate(ins["tokens"]):
        batch = distribute_tree({{"tokens": tok, "cache_len":
                                 torch.tensor(8 + t, dtype=torch.int32)}},
                                bundle.batch_shardings)
        out, cache = bundle.decode_fn(params, batch, cache)
        logits.append(out.full_tensor())
save({{"logits": logits, "logit_split": str(out.placements),
      "placements": [str(t.placements) for _, t in
                                       tree_items(cache)],
      "cache": [t.full_tensor() for _, t in tree_items(cache)],
      "prefill": first.full_tensor(),
      "prefill_cache": [t.full_tensor() for _, t in tree_items(fresh)]}})
"""


# the cache's layout over "model": qwen's 4 kv heads split on (1, 2);
# starcoder2's 2 kv heads do not divide 4, so (1, 4) splits the sequence
# (the flash-decoding layout, the softmax combined over the ranks);
# rwkv6 at batch 1 on (2, 1) (long_500k's decode): one row cannot split
# over "data", so its state stays whole while the activations' layout
# splits the batch unevenly; starcoder2 with a vocabulary of 255 on
# (1, 2): its untied head runs on uneven chunks of the vocabulary and
# its logits stay split so; h2o with a window of 4 on (1, 4): a ring of
# one row a rank, the 8-token prompt's last 4 keys
SERVE_CASES = [("qwen1.5-0.5b", (1, 2), "Shard(dim=3)", 2, {}),
               ("starcoder2-7b", (1, 4), "Shard(dim=2)", 2, {}),
               ("rwkv6-7b", (2, 1), "Replicate(), Replicate()", 1, {}),
               ("starcoder2-7b", (1, 2), "Shard(dim=3)", 2,
                {"vocab_size": 255}),
               ("h2o-danube-3-4b", (1, 4), "Shard(dim=2)", 2,
                {"sliding_window": 4})]


@pytest.mark.parametrize("arch,shape,split,batch,over", SERVE_CASES,
                         ids=["qwen_heads", "starcoder2_sequence",
                              "rwkv6_batch1", "starcoder2_vocab255",
                              "h2o_ring_sequence"])
def test_serve_decode_over_a_mesh_matches_one_device(tmp_path, arch, shape,
                                                     split, batch, over):
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    model = build_model(cfg, device="cpu")
    params = init_model_params(model, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 8)),
                             dtype=torch.int32)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 1)),
                            dtype=torch.int32) for _ in range(3)]
    with torch.no_grad():
        empty = init_cache(model, batch, 32, device="cpu")
        first, cache = model.prefill(params, {"tokens": prompt}, empty)
        torch.save({"params": params, "cache": cache, "tokens": toks,
                    "prompt": prompt, "empty": empty},
                   tmp_path / "serve_in.pt")
        prefilled = [t.clone() for _, t in L.tree_items(cache)]
        want = []
        for t, tok in enumerate(toks):
            out, cache = model.decode(params, {"tokens": tok,
                                               "cache_len": 8 + t}, cache)
            want.append(out)
    got = run_ranks(tmp_path, shape[0] * shape[1],
                    _SERVE_RANK.format(arch=arch, shape=shape, batch=batch,
                                       over=over))
    for r, g in enumerate(got):
        assert any(split in p for p in g["placements"]), g["placements"]
        if cfg.vocab_size % shape[1]:
            assert "Shard(dim=2)" in g["logit_split"], g["logit_split"]
        np.testing.assert_allclose(g["prefill"].numpy(), first.numpy(),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(g["prefill_cache"], prefilled):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        for a, b in zip(g["logits"], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
        for a, (_, b) in zip(g["cache"], L.tree_items(cache)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


_PREFILL_RANK = """
import dataclasses, pickle
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, init_cache, params_from_numpy
from repro_torch.models.layers import tree_items
from repro_torch.serve.step import make_serve_step
from repro_torch.sharding.rules import distribute_tree
with open(os.path.join(out_dir, "..", "prefill_in.pkl"), "rb") as f:
    ins = pickle.load(f)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
model = build_model(dataclasses.replace(reduced(get_config(ins["arch"])),
                                        **ins["over"]), device="cpu")
prompt = torch.as_tensor(ins["prompt"])
B, n = prompt.shape[0], ins["max_len"]
bundle = make_serve_step(
    model, mesh, {"tokens": torch.empty(tuple(prompt.shape),
                                        dtype=torch.int32, device="meta")},
    batch_size=B, max_len=n)
with torch.no_grad():
    out, cache = bundle.prefill_fn(
        distribute_tree(params_from_numpy(model, ins["params"],
                                          device="cpu"),
                        bundle.param_shardings),
        distribute_tree({"tokens": prompt}, bundle.batch_shardings),
        distribute_tree(init_cache(model, B, n, device="cpu"),
                        bundle.cache_shardings))
save({"logits": out.full_tensor(),
      "placements": [str(t.placements) for _, t in tree_items(cache)],
      "cache": [t.full_tensor() for _, t in tree_items(cache)]})
"""

# the reference's serve prefill over a (1, 4) mesh of forced host devices
_REF_PREFILL = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_config, reduced
from repro.models import build_model, init_cache
from repro.serve.step import make_serve_step
with open(sys.argv[1], "rb") as f:
    ins = pickle.load(f)
model = build_model(dataclasses.replace(reduced(get_config(ins["arch"])),
                                        **ins["over"]))
prompt = jnp.asarray(ins["prompt"], jnp.int32)
B, n = prompt.shape[0], ins["max_len"]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
with mesh:
    bd = make_serve_step(model, mesh, {"tokens": jax.ShapeDtypeStruct(
        prompt.shape, jnp.int32)}, batch_size=B, max_len=n)
    out, cache = bd.prefill_fn(jax.tree.map(jnp.asarray, ins["params"]),
                               {"tokens": prompt}, init_cache(model, B, n))
with open(sys.argv[2], "wb") as f:
    pickle.dump({"logits": np.asarray(out),
                 "cache": jax.tree.map(np.asarray, cache)}, f)
"""

# reduced h2o with a window of 4: the ring written from the heads moved
# back to the cache's sequence split; reduced starcoder2 into a cache as
# long as its prompt: each rank writes its own rows
REF_PREFILL_CASES = {"h2o_ring": ("h2o-danube-3-4b", {"sliding_window": 4},
                                  32),
                     "starcoder2_own_rows": ("starcoder2-7b", {}, 8)}


@pytest.mark.parametrize("case", list(REF_PREFILL_CASES))
def test_sequence_split_prefill_matches_the_reference_on_its_mesh(tmp_path,
                                                                  case):
    """The port's serve prefill over (1, 4), the cache's sequence split
    (2 kv heads: K and V projected on each rank's positions and each
    rank's kv heads moved to it), against the reference's serve prefill
    over the same mesh of forced host devices, on the same weights (the
    port's seed 0) and an 8-token prompt of 2 rows: logits and cache
    within the bounds the port's model is held to against the
    reference's (`test_torch_models.LOGIT_TOL` and ``FN_TOL``)."""
    import pickle

    from test_torch_dryrun import _finish, _python
    from test_torch_models import FN_TOL, LOGIT_TOL

    arch, over, max_len = REF_PREFILL_CASES[case]
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    params = init_model_params(build_model(cfg, device="cpu"), 0,
                               device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    with open(tmp_path / "prefill_in.pkl", "wb") as f:
        pickle.dump({"arch": arch, "over": over, "max_len": max_len,
                     "prompt": prompt.astype(np.int32),
                     "params": L.tree_map(lambda t: t.numpy(), params)}, f)
    ref = _python(_REF_PREFILL, str(tmp_path / "prefill_in.pkl"),
                  str(tmp_path / "ref.pkl"),
                  env={"XLA_FLAGS":
                       "--xla_force_host_platform_device_count=4"})
    try:
        got = run_ranks(tmp_path, 4, _PREFILL_RANK)
        _finish(ref, timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    for g in got:
        assert any("Shard(dim=2)" in p for p in g["placements"]), \
            g["placements"]
        np.testing.assert_allclose(g["logits"].numpy(), want["logits"],
                                   **LOGIT_TOL)
        for a, (_, b) in zip(g["cache"], L.tree_items(want["cache"]),
                             strict=True):
            np.testing.assert_allclose(a.numpy(), b, **FN_TOL)


_VL_RANK = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, init_cache
from repro_torch.serve.step import make_serve_step
from repro_torch.models.layers import tree_items
from repro_torch.sharding.rules import distribute_tree
mesh = init_device_mesh("cpu", {shape}, mesh_dim_names=("data", "model"))
model = build_model(reduced(get_config("qwen2-vl-2b")), device="cpu")
ins = torch.load(os.path.join(out_dir, "..", "vl_in.pt"))
meta = {{k: torch.empty(v.shape, dtype=v.dtype, device="meta")
        for k, v in ins["batch"].items()}}
bundle = make_serve_step(model, mesh, meta, batch_size=2, max_len=16)
with torch.no_grad():
    out, cache = bundle.prefill_fn(
        distribute_tree(ins["params"], bundle.param_shardings),
        distribute_tree(ins["batch"], bundle.batch_shardings),
        distribute_tree(init_cache(model, 2, 16, device="cpu"),
                        bundle.cache_shardings))
save({{"logits": out.full_tensor(),
      "placements": [str(t.placements) for _, t in tree_items(cache)],
      "cache": [t.full_tensor() for _, t in tree_items(cache)]}})
"""


def _qwen2vl_prefill(tmp_path):
    """Reduced qwen2-vl, its weights and a prefill batch of 2 x 16 with
    patch embeddings, saved for the ranks; the one-device prefill's
    logits and cache into 16 rows."""
    from repro_torch.configs import input_specs
    from repro_torch.configs.base import ShapeSpec

    cfg = reduced(get_config("qwen2-vl-2b"))
    model = build_model(cfg, device="cpu")
    params = init_model_params(model, 0, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {k: (torch.randn(tuple(v.shape), generator=g, dtype=v.dtype)
                 if v.dtype.is_floating_point else
                 torch.randint(0, 256, tuple(v.shape), generator=g,
                               dtype=v.dtype))
             for k, v in input_specs(cfg, ShapeSpec("p", 16, 2,
                                                    "prefill")).items()}
    assert "patch_emb" in batch
    torch.save({"params": params, "batch": batch}, tmp_path / "vl_in.pt")
    with torch.no_grad():
        return model.prefill(params, batch,
                             init_cache(model, 2, 16, device="cpu"))


def test_qwen2vl_prefill_with_patches_over_a_mesh_matches_one_device(
        tmp_path):
    """Reduced qwen2-vl's prefill with its patch embeddings on a (1, 2)
    mesh, the vocabulary split over "model": the lookup runs on local
    shards (`models/layers.py:_embed_local`). DTensor's own
    vocabulary-parallel rule failed here on gloo ("MaskBuffer has been
    materialized with conflicting data")."""
    want, _ = _qwen2vl_prefill(tmp_path)
    for g_ in run_ranks(tmp_path, 2, _VL_RANK.format(shape=(1, 2))):
        np.testing.assert_allclose(g_["logits"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_qwen2vl_prefill_into_a_sequence_split_cache_matches_one_device(
        tmp_path):
    """The same prefill on (1, 4), into a cache as long as the prompt:
    its 2 kv heads do not divide 4, so the cache's sequence is split,
    each rank projects K and V on its 4 positions (their M-RoPE
    positions sliced alike) and writes them as its own cache rows, and
    attention reads the kv head its query heads need, moved to it by an
    all-to-all. Logits and cache match the one-device
    prefill's, the cache within the logits' bound (a rank's product over
    4 rows rounds otherwise than one over 16: 1.07e-6 at most here)."""
    want, cache = _qwen2vl_prefill(tmp_path)
    for g_ in run_ranks(tmp_path, 4, _VL_RANK.format(shape=(1, 4))):
        assert any("Shard(dim=2)" in p for p in g_["placements"]), \
            g_["placements"]
        np.testing.assert_allclose(g_["logits"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        for a, (_, b) in zip(g_["cache"], L.tree_items(cache), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.fixture
def local_mesh():
    import torch.distributed as dist

    mesh = make_local_mesh(data=1, model=1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_serve_step_on_one_rank_is_bitwise_the_model(local_mesh):
    """On a one-rank mesh the serve step is ``model.prefill`` /
    ``model.decode`` on the same weights and cache, bitwise, and decode
    writes the cache in place; a decode that does not write its cache
    back is caught."""
    model = build_model(reduced(get_config("qwen1.5-0.5b")), device="cpu")
    params = init_model_params(model, 0, device="cpu")
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, 256, (2, 8)), dtype=torch.int32)
    meta = {"tokens": torch.empty(2, 8, dtype=torch.int32, device="meta")}
    bundle = make_serve_step(model, local_mesh, meta, batch_size=2,
                             max_len=16)
    dp = distribute_tree(params, bundle.param_shardings)
    with torch.no_grad():
        c0 = init_cache(model, 2, 16, device="cpu")
        want, wc = model.prefill(params, {"tokens": prompt}, c0)
        got, gc = bundle.prefill_fn(
            dp, distribute_tree({"tokens": prompt}, bundle.batch_shardings),
            distribute_tree(c0, bundle.cache_shardings))
        assert torch.equal(got.full_tensor(), want)
        for t in range(3):
            tok = want.argmax(-1).to(torch.int32)
            before = [t_.to_local().clone() for _, t_ in L.tree_items(gc)]
            want, wc = model.decode(params, {"tokens": tok,
                                             "cache_len": 8 + t}, wc)
            got, gc2 = bundle.decode_fn(dp, {"tokens": tok,
                                             "cache_len": 8 + t}, gc)
            assert gc2 is gc
            assert torch.equal(got.full_tensor(), want)
            for (_, a), (_, b), c in zip(L.tree_items(gc), L.tree_items(wc),
                                         before):
                assert torch.equal(a.to_local(), b)
            assert any(not torch.equal(a.to_local(), c) for (_, a), c in
                       zip(L.tree_items(gc), before))


# ---------------------------------------------------------------------------
# C.8: rwkv6's decode against its forward
# ---------------------------------------------------------------------------

def _tool():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import cache_vs_forward_reference as tool
    finally:
        sys.path.pop(0)
    return tool


def _tokens(tool, seed: int = 1):
    return np.random.default_rng(seed).integers(
        1, tool.WIDTHS["vocab_size"],
        (tool.BATCH, tool.PROMPT + tool.STEPS)).astype(np.int32)


def _rwkv_leaves(cache):
    seg = cache["seg0"]
    return {k: seg[key][k].double().numpy() for key in seg
            for k in ("s", "att_prev", "ffn_prev")}


@pytest.mark.parametrize("n_layers", [2, 4])
def test_rwkv6_decode_state_is_the_forward_state(n_layers):
    """Per layer and step: the state after prefill + decode against a
    prefill over the extended sequence. The float32 WKV state agrees to
    float32 rounding (the step form against the chunked sums), the
    token-shift leaves to one bfloat16 rounding of a layer input."""
    tool = _tool()
    model = build_model(tool.cut(get_config("rwkv6-7b"), n_layers),
                        device="cpu")
    params = init_model_params(model, 0, device="cpu")
    toks = torch.as_tensor(_tokens(tool))
    P, B = tool.PROMPT, tool.BATCH
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :P]},
                                 init_cache(model, B, tool.MAX_LEN,
                                            device="cpu"))
        for t in range(tool.STEPS):
            model.decode(params, {"tokens": toks[:, P + t:P + t + 1],
                                  "cache_len": torch.full((B,), P + t)},
                         cache)
            _, fwd = model.prefill(params, {"tokens": toks[:, :P + t + 1]},
                                   init_cache(model, B, tool.MAX_LEN,
                                              device="cpu"))
            got, want = _rwkv_leaves(cache), _rwkv_leaves(fwd)
            for layer in range(n_layers):
                s, s0 = got["s"][layer], want["s"][layer]
                assert np.abs(s - s0).max() <= 1e-6 * np.abs(s0).max(), \
                    (t, layer)
                for k in ("att_prev", "ffn_prev"):
                    a, b = got[k][layer], want[k][layer]
                    assert np.abs(a - b).max() <= 2.0 ** -7 * \
                        np.abs(b).max(), (t, layer, k)


# `tools/cache_vs_forward_reference.py`'s readings on the CPU at 2
# layers, token seed 1: each of the 4 decode steps' relative L2 error of
# the logits against the forward's (see ROADMAP C.8)
C8_PINNED = {"reference": [0.0, 0.0, 0.0, 0.0],
             "port": [0.0, 0.0, 0.00094, 0.0]}


def test_rwkv6_cache_vs_forward_readings_are_pinned():
    tool = _tool()
    toks = _tokens(tool)
    jparams, jsteps, jfull = tool.reference_run("rwkv6-7b", 2, toks)
    tsteps, tfull = tool.port_run("rwkv6-7b", 2, toks, jparams)
    got = {"reference": [tool.rel_err(a, b) for a, b in zip(jsteps, jfull)],
           "port": [tool.rel_err(a, b) for a, b in zip(tsteps, tfull)]}
    for k, want in C8_PINNED.items():
        np.testing.assert_allclose(got[k], want, atol=5e-5, err_msg=k)
