"""Roofline bounds for one NVIDIA H100 SXM (the port's counterpart of the
JAX package's `analysis/roofline.py`, whose constants are a TPU v5e's).

Two kinds of bound live here:

* the three-term roofline of a dry-run cell (`launch/dryrun.py`'s
  records, counted by `analysis/op_cost.py` per device):

      compute_s    = per-device product FLOPs / 989e12     (dense bf16)
      memory_s     = per-device bytes / 3.35e12            (HBM3)
      collective_s = per-device collective bytes (ring-factored) / link:
                     NVLink 4, 450 GB/s a direction, inside a node of 8
                     consecutive ranks; InfiniBand NDR, 50 GB/s a GPU,
                     for the share in groups that cross nodes

  with the model FLOPs (6 N_active D for a train step, 2 N_active D for
  inference), the useful share of the counted FLOPs, the dominant term
  and an MFU bound = model FLOPs / (peak x the largest term). The bytes
  are counted unfused (every operation's inputs and outputs, as eager
  PyTorch runs them);

* the least time of one step on one card worked out from its shapes
  (`train_work`, `decode_work`, `prefill_work`, `family_work`), the
  bounds `chip_smoke.py` prints beside its measurements.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

__all__ = ["PEAK_FLOPS", "PEAK_FP32", "HBM_BW", "NVLINK_BW", "IB_BW",
           "active_param_count", "cell_roofline", "rec_tokens",
           "rec_batch", "build_tables", "markdown_table", "train_work",
           "decode_work", "prefill_work", "family_work"]

PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s a direction a GPU
IB_BW = 50e9                 # InfiniBand NDR (400 Gb/s) bytes/s a GPU

# bytes on the wire a rank per byte of the collective's buffer, times
# (g - 1) / g: a ring all-reduce sends its buffer twice (reduce-scatter,
# then all-gather); a received tensor is the sender's send
_RING = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-broadcast": 1.0, "send": 1.0,
         "recv": 0.0}


def active_param_count(arch: str) -> int:
    """Non-embedding active parameters: the schema's, without the
    embedding and an untied head, MoE experts scaled by top_k / E."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import P

    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    total = 0

    def walk(node, in_moe: bool, path: str):
        nonlocal total
        if isinstance(node, P):
            n = math.prod(node.shape)
            leaf = path.rsplit("/", 1)[-1]
            if leaf == "embedding" or path.endswith("head/w"):
                return
            if in_moe and leaf in ("w_gate", "w_in", "w_out"):
                n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
            total += n
            return
        for k, v in node.items():
            walk(v, in_moe or k == "moe", f"{path}/{k}")

    walk(model.schema, False, "")
    return total


def _shape(rec: dict) -> tuple:
    """(global batch, sequence length) of a record's cell."""
    if "global_batch" in rec:
        return rec["global_batch"], rec["seq_len"]
    from repro_torch.configs import SHAPES

    s = SHAPES[rec["shape"]]
    return s.global_batch, s.seq_len


def rec_tokens(rec: dict) -> int:
    b, s = _shape(rec)
    return b * s


def rec_batch(rec: dict) -> int:
    return _shape(rec)[0]


def cell_roofline(rec: dict, n_active: int) -> dict:
    """The three terms of one dry-run record (`launch/dryrun.py`) and
    what they bound."""
    oc = rec["op_cost"]
    devices = rec["devices"]
    compute_s = oc["flops"] / PEAK_FLOPS
    memory_s = oc["bytes"] / HBM_BW
    nvlink_s = ib_s = 0.0
    for op, v in oc["collectives"].items():
        g = max(2, v.get("group_size", 2))
        factor = _RING.get(op, 1.0) * (g - 1) / g
        nvlink_s += (v["bytes"] - v.get("ib_bytes", 0)) * factor / NVLINK_BW
        ib_s += v.get("ib_bytes", 0) * factor / IB_BW
    collective_s = nvlink_s + ib_s
    kind = rec["kind"]
    if kind == "train":
        model_flops = 6.0 * n_active * rec_tokens(rec) / devices
    elif kind == "prefill":
        model_flops = 2.0 * n_active * rec_tokens(rec) / devices
    else:
        model_flops = 2.0 * n_active * rec_batch(rec) / devices
    terms = (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s))
    dominant, bound_s = max(terms, key=lambda t: t[1])
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "ib_s": ib_s,
        "dominant": dominant, "bound_s": bound_s,
        "model_flops": model_flops,
        "useful_ratio": model_flops / oc["flops"] if oc["flops"] else 0.0,
        "mfu_bound": model_flops / (PEAK_FLOPS * bound_s) if bound_s else 0.0,
        "compute_fraction": compute_s / bound_s if bound_s else 0.0,
    }


def build_tables(dryrun_dir: str = "results/dryrun_torch") -> list:
    """One row a successful cell record in ``dryrun_dir``."""
    cache: dict = {}
    rows = []
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("status") != "ok" or "arch" not in r or "op_cost" not in r:
            continue
        arch = r["arch"]
        if arch not in cache:
            cache[arch] = active_param_count(arch)
        rl = cell_roofline(r, cache[arch])
        rows.append({**{k: r[k] for k in ("arch", "shape", "mesh", "kind",
                                          "devices", "n_params")},
                     "n_active": cache[arch], **rl,
                     "flops": r["op_cost"]["flops"],
                     "bytes": r["op_cost"]["bytes"],
                     "coll_bytes": r["op_cost"]["collective_bytes"],
                     "ib_bytes": r["op_cost"]["collective_ib_bytes"],
                     "memory": r.get("memory", {})})
    return rows


def markdown_table(rows, mesh: str = "single") -> str:
    out = ["| arch | shape | dom | compute_s | memory_s | coll_s | ib_s | "
           "MFU-bound | useful |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['dominant'][:4]} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['ib_s']:.3e} "
            f"| {r['mfu_bound'] * 100:.1f}% | {r['useful_ratio']:.2f} |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# One card: the least time of a step, from its shapes
# ---------------------------------------------------------------------------

def train_work(model, n_tokens: int, seq: int, rows: int) -> dict:
    """The least time of one train step on one card, worked out from the
    shapes (TF32 off): the float32 head's three products (forward and two
    backward) at 67 TFLOP/s, the bfloat16 body's 6 operations a weight a
    token and attention's 3 x 4 dh a live pair a head at 989 TFLOP/s,
    and AdamW's 7 float32 reads and writes a parameter (p, g, m, v read;
    p, m, v written) at 3.35 TB/s; their sum, each part run after the
    other."""
    from repro_torch.models.layers import param_count

    cfg = model.cfg
    n_params = param_count(model.schema)
    body = n_params - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    head_ops = 3 * 2 * n_tokens * cfg.d_model * cfg.vocab_size
    pairs = rows * seq * (seq + 1) // 2
    attn_ops = 3 * 4 * cfg.hd * cfg.num_heads * pairs * cfg.num_layers
    body_ops = 6 * body * n_tokens + attn_ops
    opt_bytes = 7 * 4 * n_params
    parts = {"head_ms": head_ops / PEAK_FP32 * 1e3,
             "body_ms": body_ops / PEAK_FLOPS * 1e3,
             "adamw_ms": opt_bytes / HBM_BW * 1e3}
    return {**parts, "bound_ms": sum(parts.values()), "params": n_params,
            "head_tflop": head_ops / 1e12, "body_tflop": body_ops / 1e12,
            "adamw_gb": opt_bytes / 1e9}


def decode_work(cfg, weight_bytes: int, layer_params: int, n_rows: int,
                contexts) -> tuple:
    """(bytes, operations) one decode step over ``n_rows`` slots must
    move and do: every weight once (the layers' in bfloat16, norm scales
    and the float32 embedding that the tied head reads in full), each live
    slot's K and V rows up to its position once, the new rows and the
    float32 logits written once; products of 2 operations a weight a row,
    attention's 4 dh a live pair."""
    kv_row = 2 * cfg.num_kv_heads * cfg.hd * 2 * cfg.num_layers   # K+V bf16
    live = int(sum(contexts))
    nbytes = (weight_bytes + kv_row * live + kv_row * n_rows
              + n_rows * cfg.vocab_size * 4)
    ops = (2 * layer_params * n_rows + 2 * cfg.vocab_size * cfg.d_model
           * n_rows + 4 * cfg.hd * cfg.num_heads * live * cfg.num_layers)
    return nbytes, ops


def prefill_work(cfg, weight_bytes: int, layer_params: int, n_rows: int,
                 width: int) -> tuple:
    """(bytes, operations) of one bucket's prefill over ``n_rows`` slots
    of ``width`` tokens: weights once, the K/V rows written once, the
    last position's logits; 2 operations a weight a token, causal
    attention's 4 dh a pair, the head on one row a slot."""
    kv_row = 2 * cfg.num_kv_heads * cfg.hd * 2 * cfg.num_layers
    tokens = n_rows * width
    pairs = n_rows * width * (width + 1) // 2
    nbytes = weight_bytes + kv_row * tokens + n_rows * cfg.vocab_size * 4
    ops = (2 * layer_params * tokens + 4 * cfg.hd * cfg.num_heads * pairs
           * cfg.num_layers + 2 * cfg.vocab_size * cfg.d_model * n_rows)
    return nbytes, ops


def family_work(model, cparams, n_rows: int, contexts, max_len: int) -> \
        tuple:
    """(bytes, operations) one decode step over ``n_rows`` slots must move
    and do: every weight once (of an untied embedding only the ``n_rows``
    rows looked up; MoE's dense dispatch reads every expert), each live
    slot's K/V rows up to its position once and the new rows once, every
    recurrent state leaf read and written once, the float32 logits
    written once; 2 operations a weight a row, attention's 4 dh a live
    pair a head an attention layer."""
    from repro_torch.models.layers import tree_items

    cfg = model.cfg
    nbytes = ops = 0
    for path, t in tree_items(cparams):
        if path[0] == "embed" and not cfg.tie_embeddings:
            nbytes += n_rows * cfg.d_model * t.element_size()
            continue
        nbytes += t.numel() * t.element_size()
        if t.dim() >= 2:
            ops += 2 * t.numel() * n_rows
    live = int(sum(contexts))
    for path, p in tree_items(model.cache_schema(n_rows, max_len)):
        size = math.prod(p.shape) * p.dtype.itemsize
        if "seq" in p.axes:
            nbytes += size // (n_rows * p.shape[p.axes.index("seq")]) * (
                live + n_rows)
            if path[-1] == "k":
                ops += 4 * cfg.hd * cfg.num_heads * live * p.shape[0]
        else:
            nbytes += 2 * size
    return nbytes + n_rows * cfg.vocab_size * 4, ops
