"""The port's dry run (`launch/dryrun.py`, `launch/dryrun_pp.py`) and its
cost model (`analysis/op_cost.py`, `analysis/roofline.py`) against the
JAX package's, on the CPU.

The reference lowers each cell with XLA over forced host devices on a
mesh it builds with Auto axes (ROADMAP C.2) and counts the optimised
HLO (`analysis/hlo_cost.py`); the port traces the same cell on a fake
process group as "meta" ``DTensor``s and counts the operations one rank
runs. Per-device FLOPs must agree within 5%:

* qwen1.5-0.5b cut to 2 layers, d_model 128, 2 heads of 64, d_ff 256,
  vocab 512, one train step of 8 x 64 tokens, on (1, 1), (8, 1) and
  (2, 4) meshes (8 forced host devices for the reference);
* qwen1.5-0.5b's decode_32k and train_4k on the 16 x 16 mesh.

One approximation of the reference's is undone first: `hlo_cost` weighs
each branch of a ``lax.cond`` by 0.5, and blockwise attention runs every
(q chunk, kv chunk) pair through one, so it counts half of the n^2 pairs
of a causal grid of n > 1 chunks where n(n + 1) / 2 run
(`chunk_grid_flops`; with one chunk XLA folds the cond). The port counts
the pairs it runs. The agreement found: decode_32k and the cut step at
(1, 1) and (8, 1) are equal; (2, 4) reads 3.8% above the reference (XLA
splits the 16 padded heads' groups where DTensor repeats the 2 kv heads
over them); train_4k equals the reference plus the grid's pairs to
0.01%.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import roofline as jroofline
from repro_torch.analysis import roofline
from repro_torch.configs import ASSIGNED, get_config

ROOT = Path(__file__).resolve().parents[1]

CUT = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
           head_dim=64, d_ff=256, vocab_size=512)
CUT_MESHES = ("1x1", "8x1", "2x4")
FLOPS_TOL = 0.05

_REF = """
import dataclasses, json, os
os.environ["_REPRO_EXTRA_XLA_FLAGS"] = ""
from repro.launch.dryrun import lower_cell      # forces 512 host devices
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.analysis.hlo_cost import analyze
from repro.configs import get_config, input_specs
from repro.configs.base import ShapeSpec
from repro.models import build_model
from repro.sharding.rules import Strategy
from repro.train import optim
from repro.train.step import make_train_step

def mesh(d, m):
    return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), **CUT)
model = build_model(cfg)
batch = input_specs(cfg, ShapeSpec("t", 64, 8, "train"))
for name in CUT_MESHES:
    mh = mesh(*map(int, name.split("x")))
    with mh:
        b = make_train_step(model, optim.OptConfig(), mh, batch,
                            strategy=Strategy("train"))
        hlo = b.step_fn.lower(b.abstract_state, batch).compile().as_text()
    out["cut " + name] = analyze(hlo)
for shape in ("decode_32k", "train_4k"):
    mh = mesh(16, 16)
    with mh:
        lowered, _ = lower_cell("qwen1.5-0.5b", shape, mh)
        out[shape] = analyze(lowered.compile().as_text())
print(json.dumps(out))
"""

_PORT_CUT = """
import json, sys
from pathlib import Path
from repro_torch.launch.dryrun import run_cell
out = {}
for name in CUT_MESHES:
    rec = run_cell("qwen1.5-0.5b", "train_8x64", name, Path(sys.argv[1]),
                   overrides=CUT)
    out["cut " + name] = rec
print(json.dumps(out))
"""


def _python(code: str, *args, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", **(env or {})})


def _finish(proc, timeout: int = 900):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file at once: the reference's counts (one
    subprocess), the port's cut cells (one) and the CLI on the two
    production cells (one each)."""
    out = tmp_path_factory.mktemp("dryrun")
    consts = f"CUT = {CUT!r}\nCUT_MESHES = {CUT_MESHES!r}\n"
    procs = {
        "reference": _python(consts + _REF),
        "cut": _python(consts + _PORT_CUT, str(out)),
        **{shape: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen1.5-0.5b", "--shape", shape, "--mesh", "single", "--out",
             str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
           for shape in ("decode_32k", "train_4k")}}
    try:
        res = {k: _finish(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = json.loads(res["reference"].strip().splitlines()[-1])
    port = json.loads(res["cut"].strip().splitlines()[-1])
    for shape in ("decode_32k", "train_4k"):
        port[shape] = json.loads(
            (out / f"qwen1.5-0.5b__{shape}__single.json").read_text())
    return ref, port, out


def chunk_grid_flops(cfg, seq: int, seqs: float, heads: float,
                     passes: int) -> float:
    """The attention FLOPs the port's chunk grid runs beyond the ones
    `hlo_cost` counts. Of the n_q x n_k (q chunk, kv chunk) pairs (chunks
    of qc = q_chunk and kc = kv_chunk rows, n_q = seq / qc, n_k = seq /
    kc) the port runs the live ones: pair (i, j) where the causal mask
    leaves it, j kc <= i qc + qc - 1, and a sliding window W leaves it,
    i qc - j kc <= W + kc - 2 (n(n + 1) / 2 of n^2 without a window;
    with qc = kc = c, sum over i of min(i + 1, floor((W + c - 2) / c) +
    1)). `hlo_cost` counts every pair's cond at 0.5, n_q n_k / 2. Each
    pair's QK^T and PV is 2 x 2 qc kc dh, over ``seqs`` sequences and
    ``heads`` heads a device, every layer, ``passes`` times (forward 1, a
    rematerialised train step 4). Negative where a window leaves fewer
    than half the pairs live."""
    qc, kc = min(cfg.q_chunk, seq), min(cfg.kv_chunk, seq)
    nq, nk = seq // qc, seq // kc
    if nq * nk == 1:           # XLA folds the one pair's cond
        return 0.0
    w = cfg.sliding_window
    live = sum(1 for i in range(nq) for j in range(nk)
               if j * kc <= i * qc + qc - 1
               and (not w or i * qc - j * kc <= w + kc - 2))
    pair = 2 * 2 * qc * kc * cfg.hd
    return (live - nq * nk / 2) * pair * seqs * heads * cfg.num_layers * \
        passes


@pytest.mark.parametrize("name", ASSIGNED)
def test_active_param_count_matches_reference(name):
    assert roofline.active_param_count(name) == \
        jroofline.active_param_count(name)


@pytest.mark.parametrize("kind,shape", [("train", "train_4k"),
                                        ("prefill", "prefill_32k"),
                                        ("decode", "decode_32k")])
def test_cell_roofline_matches_reference_at_h100_constants(
        monkeypatch, kind, shape):
    """The same record through both: the reference's constants set to
    H100's (its ICI becomes NVLink, its DCN InfiniBand)."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.NVLINK_BW)
    monkeypatch.setattr(jroofline, "DCN_BW", roofline.IB_BW)
    colls = {"all-reduce": (49, 3.2e9, 16, 1.1e9),
             "all-gather": (50, 2.5e10, 16, 0.0),
             "reduce-scatter": (7, 4.0e8, 256, 4.0e8),
             "all-to-all": (2, 6.5e5, 8, 0.0)}
    base = {"arch": "qwen1.5-0.5b", "shape": shape, "kind": kind,
            "devices": 256}
    for flops, nbytes in ((2.07e9, 3.19e10), (1.47e13, 9.0e11),
                          (5.0e14, 1.0e9)):
        rec = {**base, "op_cost": {
            "flops": flops, "bytes": nbytes,
            "collectives": {k: {"count": c, "bytes": b, "group_size": g,
                                "ib_bytes": ib}
                            for k, (c, b, g, ib) in colls.items()}}}
        jrec = {**base, "hlo_cost": {
            "flops": flops, "bytes": nbytes,
            "collectives": {k: {"count": c, "bytes": b, "group_size": g,
                                "dcn_bytes": ib}
                            for k, (c, b, g, ib) in colls.items()}}}
        n = roofline.active_param_count("qwen1.5-0.5b")
        got, want = roofline.cell_roofline(rec, n), \
            jroofline.cell_roofline(jrec, n)
        want["ib_s"] = want.pop("dcn_s")
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v, k
            else:
                assert got[k] == pytest.approx(v, rel=1e-12), k


@pytest.mark.parametrize("mesh", CUT_MESHES)
def test_cut_train_step_flops_match_reference(runs, mesh):
    ref, port, _ = runs
    rec = port["cut " + mesh]
    assert rec["status"] == "ok", rec.get("error")
    want = ref["cut " + mesh]["flops"]
    assert abs(rec["op_cost"]["flops"] - want) <= FLOPS_TOL * want, \
        (rec["op_cost"]["flops"], want)


def test_cli_writes_the_decode_32k_record(runs):
    """The counterpart of `tests/test_system.py::
    test_dryrun_one_cell_subprocess`."""
    _, port, _ = runs
    rec = port["decode_32k"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 256
    assert rec["op_cost"]["flops"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_production_cell_flops_match_reference(runs, shape):
    ref, port, _ = runs
    rec = port[shape]
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("qwen1.5-0.5b")
    seq, batch = rec["seq_len"], rec["global_batch"]
    extra = 0.0
    if rec["kind"] == "train":
        # batch over data (16), the 16 heads over model (16)
        extra = chunk_grid_flops(cfg, seq, batch / 16, cfg.num_heads / 16,
                                 passes=4)
    want = ref[shape]["flops"] + extra
    assert abs(rec["op_cost"]["flops"] - want) <= FLOPS_TOL * want, \
        (rec["op_cost"]["flops"], ref[shape]["flops"], extra)


def test_roofline_tables_read_the_records(runs):
    """`build_tables` over the CLI's records: one row a successful cell
    with its roofline, as `cell_roofline` gives it; `markdown_table`
    prints the single-pod rows."""
    _, port, out = runs
    rows = roofline.build_tables(str(out))
    cells = {(r["arch"], r["shape"], r["mesh"]) for r in rows}
    assert ("qwen1.5-0.5b", "decode_32k", "single") in cells
    for r in rows:
        rec = port.get(r["shape"]) or port["cut " + r["mesh"]]
        assert r["dominant"] == rec["roofline"]["dominant"]
        assert r["bound_s"] == pytest.approx(rec["roofline"]["bound_s"])
    table = roofline.markdown_table(rows, "single").splitlines()
    assert len(table) == 2 + sum(r["mesh"] == "single" for r in rows)


def test_dryrun_pp_bubble_and_hand_offs(tmp_path):
    from repro_torch.launch import dryrun_pp

    rec = dryrun_pp.run(tmp_path)
    assert rec["bubble_fraction"] == pytest.approx(7 / 11)
    ticks = dryrun_pp.STAGES + dryrun_pp.MICROBATCHES - 1
    assert rec["point_to_point"] == {"send": ticks - 1, "recv": ticks - 1}
    assert (tmp_path / "pp__dense24__pipe8.json").is_file()
    # rank 0 runs its 3 layers on each of its 4 microbatches of 512 tokens
    d, f = dryrun_pp.D, dryrun_pp.D_FF
    assert rec["op_cost"]["flops"] == 4 * 3 * 2 * 2 * 512 * d * f
