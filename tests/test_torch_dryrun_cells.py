"""Cut cells of the dry run's production faults, the scans' dispatch
guard and the memory tracker (`launch/dryrun.py`, `analysis/op_cost.py`),
on the CPU.

Each cell lowers a `configs.reduced` config on a small fake mesh shaped
to split the dims that failed at production size:

* rwkv6 train on (2, 2): the five mixed streams with the model width
  split over "data" and the heads over "model" (train_4k: "Cannot
  unflatten unevenly sharded tensor: output dimension 0 (size 5)");
* rwkv6 decode at batch 1 on (2, 1): one row over "data" (long_500k:
  "This operation would remove or reshape sharded dimension 1");
* llama4 train with a bfloat16 m and a qint8 v, cut to 6 layers: its 3
  stacked repeats do not divide "data" (train_4k: "Cannot unflatten
  unevenly sharded tensor: output dimension 0 (size 24)");
* qwen2-vl prefill with its patch embeddings on (2, 2): the vocabulary
  split over "model" (prefill_32k: "aten::equal ... Meta tensors");
* zamba2 train on (2, 4): the Mamba2 scans and convolutions on local
  shards in a train step;
* zamba2 train on (2, 2, 2), one layer of width 128: on a three-axis
  mesh ``DTensor`` took the Mamba2 input projection's cotangent whole
  over "model" and ran its weight gradient over the whole width on
  every model rank (train_4k on two pods: 3.234 of the reference's
  FLOPs; `models/mamba.py:_project`);
* whisper decode with a vocabulary of 255 on (2, 2): "model" does not
  divide it, and the head ran whole on every model rank (decode_32k:
  51,865 over 16, 1.376; `models/layers.py:_head`);
* deepseek-moe decode with 16 experts on (2, 4): the dispatch product
  ran for every expert on each expert rank (`models/moe.py:_dispatch`),
  and one group's tokens split over "data" (decode_32k);
* whisper train with a vocabulary of 255 on (2, 2) (train_4k: 0.796);
* starcoder2 and h2o prefill on (2, 4): 2 kv heads, which "model" does
  not divide, so the cache's sequence is split over it; the K and V
  projections ran over every position on every model rank, which kept
  only its slice (prefill_32k: deepseek-coder 1.275, llama4 1.210,
  starcoder2 1.159, qwen2-vl 1.045; `models/attention.py:_kv_on_rows`).

The zamba2, whisper decode, MoE and the two kv2 prefill cells fail on
the code before those repairs. Each must give ``ok`` with the four
memory fields, and its per-device FLOPs must lie within 5% of the
reference's `hlo_cost` on the same cut cell (its mesh built with Auto
axes over forced host devices), once the named differences of the two
counts are undone:

* the reference weighs each branch of a ``lax.cond`` by 0.5, so it
  counts half of a chunk grid's pairs, where the port runs the causal
  ones inside the sliding window (`test_torch_dryrun.chunk_grid_flops`);
* its prefill runs the head over every position and slices the last
  (``logits[:, -1:]``); the port runs it on the last position only;
* XLA splits the backward of rwkv6's two low-rank mixing products, and
  the recomputed second one, over "model"; the port runs them whole on
  every model rank (`models/rwkv.py:_mixed_streams` mixes a rank's rows
  with the mixing weights gathered);
* where "model" does not divide the vocabulary, XLA runs the head's
  input gradient over the whole vocabulary on every model rank (the
  cotangent of its padded split gathered); the port over each rank's
  chunk, as XLA runs the head's forward and its weight gradient. The
  reference counts the rest, 2 x rows x d x (V - ceil(V / m)) a
  position: at train_4k it and the chunk grid make whisper's 0.796;
* in a decode whose group of tokens is split over the data ranks, XLA
  runs the experts' output product over all of the group's capacity
  slots on every data rank; ``DTensor`` splits the hidden activations'
  slots over them first, so the port runs 1 / dp of that product (the
  experts' gate and input products run over every slot in both). The
  reference counts the rest: at decode_32k it is deepseek-moe's 0.733
  (one pod) and 0.703 (two pods), where the dispatch repair left them;
* in a prefill into a ring cache (a sliding window shorter than the
  sequence) whose KV kv heads "model" (m) does not divide, XLA runs the
  K and V projections over the kv heads split gcd(KV, m) ways, each
  head on m / gcd(KV, m) ranks, where the port runs them over each
  rank's 1 / m of the positions. The reference counts the rest, 2 x 2
  rows s d KV dh (1 / gcd(KV, m) - 1 / m) over the layers: h2o's
  prefill_32k with the windowed chunk grid and the head.

The guard on the scans: a reduced rwkv6 and zamba2 prefill dispatch as
many ``DTensor`` operations at 16 chunks as at 4 (the chunk loops run on
local shards). The memory tracker: a hand-built sequence of allocations
gives its known peak, a reduced train step reads the same peak on
"meta" tensors as on real ones, and the arguments' bytes are
`local_bytes` of the arguments.
"""
import dataclasses
import inspect
import json
import math

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.moe import _capacity
from test_torch_dryrun import _finish, _python, chunk_grid_flops

# name: (arch, kind, batch, seq, mesh, config overrides); the mesh is
# (data, model) or (pod, data, model), an override "moe.X" sets the MoE
# config's X (`cut_config`)
CELLS = {
    "rwkv6_train": ("rwkv6-7b", "train", 8, 64, (2, 2), {}),
    "rwkv6_decode_batch1": ("rwkv6-7b", "decode", 1, 64, (2, 1), {}),
    "llama4_train_qint8": ("llama4-maverick-400b-a17b", "train", 8, 64,
                           (2, 2), {"num_layers": 6}),
    "qwen2vl_prefill_patches": ("qwen2-vl-2b", "prefill", 8, 64, (2, 2), {}),
    "zamba2_train": ("zamba2-7b", "train", 8, 64, (2, 4), {}),
    "zamba2_train_pods": ("zamba2-7b", "train", 8, 16, (2, 2, 2),
                          {"num_layers": 1, "d_model": 128}),
    "whisper_decode_vocab255": ("whisper-medium", "decode", 8, 64, (2, 2),
                                {"vocab_size": 255}),
    "moe_decode": ("deepseek-moe-16b", "decode", 16, 64, (2, 4),
                   {"moe.num_experts": 16}),
    "whisper_train_vocab255": ("whisper-medium", "train", 8, 64, (2, 2),
                               {"vocab_size": 255}),
    "starcoder2_prefill_kv2": ("starcoder2-7b", "prefill", 8, 64, (2, 4), {}),
    "h2o_prefill_kv2": ("h2o-danube-3-4b", "prefill", 8, 64, (2, 4), {}),
}
FLOPS_TOL = 0.05
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "peak_bytes")
# the dispatch guard: (arch, prefill sequence lengths) at chunk 8
GUARD = (("rwkv6-7b", (32, 128)), ("zamba2-7b", (32, 128)))

def cut_config(arch, over):
    """`configs.reduced`'s cut of ``arch`` with ``over`` set on it (both
    packages' configs: the subprocesses run this function's source)."""
    cfg = reduced(get_config(arch))
    moe = {k[4:]: v for k, v in over.items() if k.startswith("moe.")}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return dataclasses.replace(cfg, **{k: v for k, v in over.items()
                                       if not k.startswith("moe.")})


_REF = """
import dataclasses, json, os
os.environ["_REPRO_EXTRA_XLA_FLAGS"] = ""
from repro.launch.dryrun import _opt_config_for   # forces 512 host devices
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.analysis.hlo_cost import analyze
from repro.configs import get_config, input_specs, reduced
from repro.configs.base import ShapeSpec
from repro.models import build_model
from repro.serve.step import make_serve_step
from repro.sharding.rules import Strategy
from repro.train.step import make_train_step

out = {}
for name, (arch, kind, b, s, shape, over) in CELLS.items():
    cfg = cut_config(arch, over)
    model = build_model(cfg)
    batch = input_specs(cfg, ShapeSpec(name, s, b, kind))
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("pod", "data", "model")[-len(shape):],
                axis_types=(AxisType.Auto,) * len(shape))
    with mesh:
        if kind == "train":
            bd = make_train_step(model, _opt_config_for(cfg), mesh, batch,
                                 strategy=Strategy("train"))
            low = bd.step_fn.lower(bd.abstract_state, batch)
        else:
            bd = make_serve_step(model, mesh, batch, batch_size=b,
                                 max_len=s, strategy=Strategy("serve"))
            fn = bd.prefill_fn if kind == "prefill" else bd.decode_fn
            low = fn.lower(bd.abstract_params, batch, bd.abstract_cache)
        out[name] = analyze(low.compile().as_text())["flops"]
print(json.dumps(out))
"""

_PORT = """
import dataclasses, json, sys
from pathlib import Path
import torch.distributed as dist
from repro_torch.analysis.op_cost import local_bytes
from repro_torch.configs import get_config, reduced
from repro_torch.launch.dryrun import fake_mesh, lower_cell, run_cell
out_dir = Path(sys.argv[1])
out = {}
for name, (arch, kind, b, s, shape, over) in CELLS.items():
    cfg = cut_config(arch, over)
    out[name] = run_cell(arch, f"{kind}_{b}x{s}", "x".join(map(str, shape)),
                         out_dir, config=cfg)
for arch, seqs in GUARD:
    for s in seqs:
        rec = run_cell(arch, f"prefill_4x{s}", "2x2", out_dir,
                       config=reduced(get_config(arch)))
        out[f"guard {arch} {s}"] = rec
# the arguments' bytes as PR 28's record gave them
name = "rwkv6_train"
arch, kind, b, s, shape, over = CELLS[name]
mesh = fake_mesh("x".join(map(str, shape)))
try:
    _, args, _ = lower_cell(arch, f"{kind}_{b}x{s}", mesh,
                            config=reduced(get_config(arch)))
    out["local_bytes " + name] = local_bytes(args)
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's counts (one subprocess) and the port's records
    (one), at once."""
    out = tmp_path_factory.mktemp("cells")
    consts = (f"CELLS = {CELLS!r}\nGUARD = {GUARD!r}\n"
              + inspect.getsource(cut_config))
    procs = {"reference": _python(consts + _REF),
             "port": _python(consts + _PORT, str(out))}
    try:
        res = {k: _finish(p, timeout=300) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {k: json.loads(v.strip().splitlines()[-1]) for k, v in res.items()}


def _cut(name):
    arch, kind, b, s, shape, over = CELLS[name]
    return cut_config(arch, over)


def _moe_layers(cfg) -> int:
    m = cfg.moe
    return sum(1 for i in range(m.first_dense, cfg.num_layers)
               if i % m.every_k_layers == m.every_k_layers - 1)


def counted_apart(name) -> float:
    """The FLOPs a device that the port counts and the reference's
    `hlo_cost` does not, less those it counts and the port does not (see
    the module's docstring), for cut cell ``name``."""
    arch, kind, b, s, shape, _ = CELLS[name]
    cfg = _cut(name)
    dp, m = math.prod(shape[:-1]), shape[-1]
    rows = b / dp if b % dp == 0 else b
    # the vocabulary a model rank holds: XLA pads an uneven split, the
    # port's first ranks hold as many columns
    vocab = math.ceil(cfg.vocab_size / m)
    extra = 0.0
    attn_layers = (cfg.num_layers // cfg.shared_attn_every
                   if cfg.shared_attn_every else
                   0 if cfg.ssm else cfg.num_layers)
    if kind != "decode" and attn_layers:
        heads = cfg.num_heads / m if cfg.num_heads % m == 0 else \
            cfg.num_heads
        extra += chunk_grid_flops(cfg, s, rows, heads, 4 if kind == "train"
                                  else 1) * attn_layers / cfg.num_layers
    if kind == "prefill":
        extra -= 2 * rows * (s - 1) * cfg.d_model * vocab
    kv = cfg.num_kv_heads
    if kind == "prefill" and attn_layers and kv % m and \
            cfg.sliding_window and cfg.sliding_window < s:
        # XLA: the ring's K and V projections over the kv heads
        share = 1 / math.gcd(kv, m) - 1 / m
        extra -= 2 * 2 * rows * s * cfg.d_model * kv * cfg.hd * share * \
            attn_layers
    if kind == "train" and cfg.vocab_size % m:
        # XLA: the head's input gradient over the whole vocabulary
        extra -= 2 * rows * s * cfg.d_model * (cfg.vocab_size - vocab)
    mo = cfg.moe
    sg = min(mo.group_size, b) if mo else 1
    while b % sg:
        sg -= 1
    if kind == "decode" and mo and (b // sg) % dp:
        # a group's tokens split over the data ranks. XLA: the experts'
        # output product over all of the group's slots on every data
        # rank; the port: over 1 / dp of them
        slots = b // sg * _capacity(sg, mo.top_k, mo.num_experts,
                                    mo.capacity_factor)
        product = 2 * mo.num_experts / m * slots * mo.d_ff_expert * \
            cfg.d_model * _moe_layers(cfg)
        extra -= product * (1 - 1 / dp)
    if kind == "train" and cfg.ssm and cfg.ssm.kind == "rwkv6":
        rank = 32                          # `rwkv_block_schema`'s lora_A
        product = 2 * rows * s * cfg.d_model * 5 * rank * cfg.num_layers
        # two products' two gradients, the second recomputed in remat
        extra += 5 * product * (1 - 1 / m)
    return extra


@pytest.mark.parametrize("name", list(CELLS))
def test_cut_cell_is_ok_with_its_memory(runs, name):
    rec = runs["port"][name]
    assert rec["status"] == "ok", rec.get("error")
    mem = rec["memory"]
    assert set(MEMORY_KEYS) <= set(mem), mem
    assert "generated_code_size_in_bytes" not in mem
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == \
        mem["peak_bytes"] - mem["argument_size_in_bytes"]


@pytest.mark.parametrize("name", list(CELLS))
def test_cut_cell_flops_match_reference(runs, name):
    rec = runs["port"][name]
    assert rec["status"] == "ok", rec.get("error")
    want = runs["reference"][name] + counted_apart(name)
    got = rec["op_cost"]["flops"]
    assert abs(got - want) <= FLOPS_TOL * want, \
        (got, runs["reference"][name], want)


@pytest.mark.parametrize("arch,seqs", GUARD, ids=[a for a, _ in GUARD])
def test_scan_dispatches_do_not_grow_with_chunks(runs, arch, seqs):
    """Not a timing test: the number of operations ``DTensor``
    dispatches in a reduced prefill is the same at 16 chunks as at 4."""
    counts = []
    for s in seqs:
        rec = runs["port"][f"guard {arch} {s}"]
        assert rec["status"] == "ok", rec.get("error")
        counts.append(rec["op_cost"]["dtensor_ops"])
    assert counts[0] > 0
    assert counts[1] == counts[0], counts


def test_argument_bytes_are_the_local_bytes_of_the_arguments(runs):
    port = runs["port"]
    assert port["rwkv6_train"]["memory"]["argument_size_in_bytes"] == \
        port["local_bytes rwkv6_train"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tracker_peak_of_a_known_sequence(device):
    """400 + 800 bytes live, 400 freed, 200 more: the peak is 1,200 and
    1,000 stay; views and in-place results add nothing."""
    from repro_torch.analysis.op_cost import OpCounter

    counter = OpCounter()
    with counter:
        a = torch.empty(100, device=device)
        b = torch.empty(200, device=device)
        b.view(10, 20).add_(1.0)
        del a
        c = torch.empty(50, device=device)
        assert counter.live == 1000
    assert counter.peak == 1200
    del b, c
    assert counter.live == 0


def test_tracker_reads_the_same_peak_on_meta_as_on_real_tensors():
    """A reduced train step on a 1 x 1 mesh: "meta" tensors and real CPU
    tensors free their storages at the same points. The models' cached
    tables are cleared before each run, so that both make theirs inside
    the count whatever ran before in the process."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.analysis.op_cost import analyze
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.models import build_model
    from repro_torch.models.attention import _inv_freq_table
    from repro_torch.models.layers import sinusoidal_positions
    from repro_torch.train import optim
    from repro_torch.train.step import (distribute_state, init_state,
                                        make_train_step)

    model = build_model(reduced(get_config("qwen1.5-0.5b")), device="cpu")
    oc = optim.OptConfig()
    toks = np.random.default_rng(0).integers(0, 256, (4, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    tree = {k: (v.shape, torch.int32) for k, v in batch.items()}
    mesh = fake_mesh("1x1")
    mem = {}
    try:
        for dev in ("meta", "cpu"):
            _inv_freq_table.cache_clear()
            sinusoidal_positions.cache_clear()
            bundle = make_train_step(model, oc, tree, device=dev, mesh=mesh)
            state = bundle.abstract_state if dev == "meta" else \
                init_state(model, oc, 0, device="cpu")
            rec = analyze(bundle.step_fn, distribute_state(state, bundle),
                          {k: torch.as_tensor(v, device=dev)
                           for k, v in batch.items()})
            mem[dev] = rec["memory"]
    finally:
        dist.destroy_process_group()
    assert mem["meta"] == mem["cpu"]
    assert mem["cpu"]["peak_bytes"] > mem["cpu"]["argument_size_in_bytes"]


def test_by_op_names_the_largest_products_with_their_shapes():
    """``analyze(..., by_op=n)``: the products summed by (operation,
    operand shapes, the port's frame), largest first; two calls of one
    product add up, and the entries sum to ``flops`` when all are
    kept. It changes no count."""
    from repro_torch.analysis.op_cost import analyze
    from repro_torch.models.layers import _linear_head

    x, w, v = (torch.ones(s, device="meta") for s in
               ((4, 8), (8, 16), (16, 2)))

    def fn(x, w, v):
        h = _linear_head(x, w)
        return _linear_head(x, w) + h, torch.matmul(h, v)

    rec = analyze(fn, x, w, v, by_op=5)
    assert rec["flops"] == analyze(fn, x, w, v)["flops"] == \
        2 * (2 * 4 * 8 * 16) + 2 * 4 * 16 * 2
    top = rec["by_op"]
    assert [e["flops"] for e in top] == [2 * 2 * 4 * 8 * 16, 2 * 4 * 16 * 2]
    assert top[0]["op"] == "mm" and top[0]["shapes"] == [[4, 8], [8, 16]]
    assert top[0]["site"].startswith("models/layers.py:")
    assert top[1]["site"] == "?"            # run from the test, not the port
    assert analyze(fn, x, w, v, by_op=1)["by_op"] == top[:1]
