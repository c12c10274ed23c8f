"""The port's paged KV cache (`repro_torch.serve.paged`,
`serve/engine.py:PagedEngine`) against the JAX package's, on the CPU, and
its invariants torch against torch.

* The pool and the table replay the reference's `PagePool`/`PageTable`
  op for op: allocation order, the scratch page, `pages_for`,
  `block_table` padding and truncation, and defrag's moves and rows
  (exact).
* The three paged helpers of `models/attention.py` equal the reference's
  jnp ones bitwise on random pools (the scatters compared off the
  scratch page, where colliding writes land in an undefined order).
* `PagedEngine`'s greedy tokens equal the reference `PagedEngine`'s at
  page sizes 4, 8 and 16 (reduced qwen1.5-0.5b, vocab 64, the JAX
  package's parameters of seed 3 carried by `params_from_numpy`, float32
  on both sides), on the ring cache of reduced h2o-danube, and on
  reduced deepseek-moe-16b (page sizes 4-16, 2 and 4 lanes). Reduced
  rwkv6 and zamba2 are refused typed by both packages.
* Sampling cannot reuse the reference's keys, so paged against dense at
  temperature 0.8, oversubscription, submission order and defrag
  mid-decode are pinned torch against torch, as the reference pins them
  JAX against JAX (`tests/test_paged.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import attention as j_att
from repro.models import build_model as j_build_model
from repro.models import init_model_params as j_init_model_params
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.paged import PagePool as JPagePool
from repro.serve.paged import PageTable as JPageTable
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as att
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Engine, PagedEngine, Request
from repro_torch.serve.errors import InsufficientPages, PagedCacheUnsupported
from repro_torch.serve.paged import (SCRATCH_PAGE, PagePool, PageTable,
                                     leaf_specs)

MAX_LEN, MAX_NEW = 64, 6
PROMPTS = {0: [3, 1, 4, 1], 1: [5, 9, 2], 2: [6, 5], 3: [8, 9, 7, 9, 3],
           4: [2, 3, 8], 5: [4, 6, 2, 6]}


def _pair(name):
    jcfg = dataclasses.replace(j_reduced(j_get_config(name)), vocab_size=64)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=3)
    cfg = dataclasses.replace(reduced(get_config(name)), vocab_size=64)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return model, params, (jm, jp, JEngine.compile_model(jm))


@pytest.fixture(scope="module")
def setup():
    return _pair("qwen1.5-0.5b")


def _serve(setup, cls, temperature, *, slots=2, rids=tuple(PROMPTS),
           order=None, max_len=MAX_LEN, **kw):
    model, params, _ = setup
    eng = cls(model, params, slots=slots, max_len=max_len,
              temperature=temperature, seed=7, device="cpu", **kw)
    for rid in (order if order is not None else rids):
        eng.add_request(Request(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    done = eng.run_to_completion(max_steps=500)
    assert sorted(r.rid for r in done) == sorted(rids)
    return {r.rid: tuple(r.out) for r in done}, eng


def _serve_ref(setup, cls, *, slots=2, rids=tuple(PROMPTS), **kw):
    jm, jp, compiled = setup[2]
    eng = cls(jm, jp, slots=slots, max_len=MAX_LEN, temperature=0.0,
              seed=7, compiled=compiled, **kw)
    for rid in rids:
        eng.add_request(JRequest(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    done = eng.run_to_completion(max_steps=500)
    return {r.rid: tuple(r.out) for r in done}, eng


@pytest.fixture(scope="module")
def dense(setup):
    """The port's dense `Engine` outputs, keyed by temperature."""
    cache = {}

    def get(temperature):
        if temperature not in cache:
            cache[temperature] = _serve(setup, Engine, temperature)[0]
        return cache[temperature]

    return get


# ---------------------------------------------------- pool and table

def _pools(setup, **kw):
    return (PagePool(setup[0], max_len=MAX_LEN, device="cpu", **kw),
            JPagePool(setup[2][0], max_len=MAX_LEN, **kw))


def _alloc_free(pool):
    out = [pool.capacity, pool.n_free, pool.alloc(3), pool.alloc(2)]
    pool.free((2, 3))
    out += [pool.n_free, pool.alloc(2), pool.alloc(1), pool.n_free]
    return out


def _insufficient(pool):
    pool.alloc(3)
    try:
        pool.alloc(pool.n_free + 1)
    except Exception as e:       # noqa: BLE001 (compared by fields)
        return type(e).__name__, e.need, e.free, e.capacity


def _pages_for(pool):
    return [pool.pages_for(n) for n in (0, 1, 7, 8, 9, 63, 64, 65, 10_000)]


def _block_table(pool, table_cls):
    table = table_cls(pool)
    table.assign("a", 3)
    table.assign("b", 1)
    out = [table.block_table(["a", None, "b"]).tolist(),
           table.block_table(["a"], width=2).tolist(),
           table.block_table([None, None]).tolist(),
           table.block_table(["b", "a"], width=5).tolist()]
    table.release("a")
    out += [table.holds("a"), table.holders(), pool.n_free,
            table.assign("c", 2), table.pages("b")]
    return out


def _defrag(pool, table_cls):
    table = table_cls(pool)
    for rid, n in (("a", 2), ("b", 2), ("c", 1), ("d", 3)):
        table.assign(rid, n)
    table.release("a")
    table.release("c")
    first = table.defrag()
    table.assign("e", 2)
    table.release("b")
    second = table.defrag()
    return [first, second, {r: table.pages(r) for r in table.holders()},
            pool.n_free, pool.alloc(2), table.defrag()]


@pytest.mark.parametrize("case,kw", [
    (_alloc_free, dict(page_size=8, n_pages=9)),
    (_insufficient, dict(page_size=8, n_pages=5)),
    (_pages_for, dict(page_size=8, n_pages=9)),
    (_pages_for, dict(page_size=5, n_pages=9)),
    (_block_table, dict(page_size=8, n_pages=9)),
    (_defrag, dict(page_size=4, n_pages=12)),
], ids=["alloc_free", "insufficient", "pages_for_8", "pages_for_5",
        "block_table", "defrag"])
def test_pool_and_table_replay_the_reference(setup, case, kw):
    mine, ref = _pools(setup, **kw)
    args = (PageTable,) if case in (_block_table, _defrag) else ()
    jargs = (JPageTable,) if args else ()
    assert case(mine, *args) == case(ref, *jargs)
    assert sorted(mine._free) == sorted(ref._free)
    assert mine._held == ref._held


def test_pool_leaves_are_zeros_shaped_as_the_reference(setup):
    mine, ref = _pools(setup, page_size=8, n_pages=9)
    assert len(mine.leaves) == len(ref.leaves)
    for a, b in zip(mine.leaves, ref.leaves):
        assert tuple(a.shape) == b.shape and not a.any()
    assert SCRATCH_PAGE == 0 and mine.capacity == 8


def test_defrag_moves_rows_as_the_reference(setup):
    """Stamp a value into one page of every leaf, leave holes, defrag:
    the stamp follows the page to its new id in both packages."""
    mine, ref = _pools(setup, page_size=8, n_pages=12)
    tables = PageTable(mine), JPageTable(ref)
    for t in tables:
        t.assign("a", 2)
        t.assign("b", 2)
        t.assign("c", 1)
    marked = tables[0].pages("b")[0]
    for leaf in mine.leaves:
        leaf[marked] = 7.0
    ref.leaves = [leaf.at[marked].set(7.0) for leaf in ref.leaves]
    for t in tables:
        t.release("a")
    moves = [t.defrag() for t in tables]
    assert moves[0] == moves[1] and marked in moves[0]
    for a, b in zip(mine.leaves, ref.leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (a[moves[0][marked]] == 7.0).all()
    assert mine.n_free == mine.capacity - 3


# ------------------------------------------------------- the helpers

def _random_case(rng, ring):
    """A 5-D pool leaf (n_pages, page, layers, KV, dh) with batch_ax 1 and
    seq_ax 2 (the stacked cache leaves' layout), a block table of
    distinct real pages per lane plus scratch padding and an empty
    lane."""
    n_pages, ps, layers, kv, dh = 14, 4, 2, 2, 3
    pool = rng.normal(size=(n_pages, ps, layers, kv, dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((3, 4), np.int32)
    bt[0, :4] = perm[:4]
    bt[1, :2] = perm[4:6]            # columns 2-3 pad with scratch
    seq_len = 10 if ring else 64     # a ring of W = 10 slots
    return pool, bt, seq_len


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_gather_page_view_bitwise(rng, ring):
    pool, bt, seq_len = _random_case(rng, ring)
    want = j_att.gather_page_view(jnp.asarray(pool), jnp.asarray(bt),
                                  batch_ax=1, seq_ax=2, seq_len=seq_len)
    got = att.gather_page_view(torch.as_tensor(pool),
                               torch.as_tensor(bt).long(), batch_ax=1,
                               seq_ax=2, seq_len=seq_len)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
def test_scatter_page_token_bitwise(rng, ring):
    pool, bt, seq_len = _random_case(rng, ring)
    sv = min(seq_len, bt.shape[1] * pool.shape[1])
    view = rng.normal(size=(2, 3, sv, 2, 3)).astype(np.float32)
    pos = np.array([13, 6, 0], np.int32)        # lane 0 wraps a ring
    want = np.asarray(j_att.scatter_page_token(
        jnp.asarray(pool), jnp.asarray(view), jnp.asarray(bt),
        jnp.asarray(pos), batch_ax=1, seq_ax=2))
    got = att.scatter_page_token(torch.tensor(pool),
                                 torch.as_tensor(view),
                                 torch.as_tensor(bt).long(),
                                 torch.as_tensor(pos), batch_ax=1, seq_ax=2)
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert not np.array_equal(want[1:], pool[1:])


@pytest.mark.parametrize("sv", [4, 7, 16], ids=lambda n: f"view{n}")
def test_scatter_page_prefill_bitwise(rng, sv):
    pool, bt, _ = _random_case(rng, False)
    view = rng.normal(size=(2, 3, sv, 2, 3)).astype(np.float32)
    want = np.asarray(j_att.scatter_page_prefill(
        jnp.asarray(pool), jnp.asarray(view), jnp.asarray(bt),
        batch_ax=1, seq_ax=2))
    got = att.scatter_page_prefill(torch.tensor(pool),
                                   torch.as_tensor(view),
                                   torch.as_tensor(bt).long(),
                                   batch_ax=1, seq_ax=2)
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


# ------------------------------------------ engine against the reference

@pytest.mark.parametrize("page_size,slots", [(4, 2), (8, 2), (16, 2),
                                             (16, 4)])
def test_greedy_tokens_equal_the_reference_paged_engine(setup, page_size,
                                                        slots):
    want, jeng = _serve_ref(setup, JPagedEngine, slots=slots,
                            page_size=page_size)
    got, eng = _serve(setup, PagedEngine, 0.0, slots=slots,
                      page_size=page_size)
    assert got == want
    assert eng.peak_admitted == jeng.peak_admitted
    assert eng.pool.n_free == eng.pool.capacity


# ---------------------------------------------- paged against dense

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("page_size", [4, 16])
def test_paged_matches_dense(setup, dense, temperature, page_size):
    out, eng = _serve(setup, PagedEngine, temperature, page_size=page_size)
    assert out == dense(temperature)
    assert eng.pool.n_free == eng.pool.capacity   # every page freed


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_oversubscription_beyond_slots(setup, dense, temperature):
    """Short requests: more concurrent admissions than decode lanes,
    bounded by free pages, the reference's peak, the dense tokens."""
    out, eng = _serve(setup, PagedEngine, temperature, slots=2, page_size=8)
    _, jeng = _serve_ref(setup, JPagedEngine, slots=2, page_size=8)
    assert out == dense(temperature)
    assert eng.peak_admitted == jeng.peak_admitted > eng.slots
    assert eng.pool.n_free == eng.pool.capacity


def test_submission_order_invariance_paged(setup):
    perm, _ = _serve(setup, PagedEngine, 0.9, page_size=8,
                     order=[5, 2, 0, 4, 1, 3])
    assert perm == _serve(setup, PagedEngine, 0.9, page_size=8)[0]


def test_defrag_mid_decode_bitwise(setup, dense):
    """Compacting pages between steps, once requests have finished and
    left holes, changes no logit: the views hold the same rows."""
    model, params, _ = setup

    def run(defrag):
        eng = PagedEngine(model, params, slots=2, max_len=MAX_LEN,
                          temperature=0.8, seed=7, device="cpu", page_size=4)
        logits = []
        real = eng._decode_dispatch

        def spy(batch):
            out = real(batch)
            logits.append(out[0].clone())
            return out
        eng._decode_dispatch = spy
        for rid in PROMPTS:
            eng.add_request(Request(rid, list(PROMPTS[rid]),
                                    max_new=MAX_NEW))
        done, moved = [], 0
        for _ in range(500):
            done += eng.step()
            if done and defrag:
                moved += len(eng.defrag())
            if not eng._work_pending():
                break
        assert eng.pool.n_free == eng.pool.capacity
        return {r.rid: tuple(r.out) for r in done}, logits, moved

    plain, plain_logits, _ = run(False)
    out, logits, moved = run(True)
    assert moved > 0
    assert out == plain == dense(0.8)
    assert len(logits) == len(plain_logits)
    assert all(torch.equal(a, b) for a, b in zip(logits, plain_logits))


def test_request_larger_than_pool_typed(setup):
    model, params, _ = setup
    eng = PagedEngine(model, params, slots=2, max_len=MAX_LEN, page_size=8,
                      n_pages=3, device="cpu")
    with pytest.raises(InsufficientPages) as ei:
        eng.add_request(Request(0, list(range(2, 30)), max_new=MAX_NEW))
    assert (ei.value.need, ei.value.capacity) == (5, 2)
    assert not eng.queue                # rejected, not half-admitted


def test_paged_engine_builds_no_dense_cache(setup, monkeypatch):
    # every K/V row lives in the pool: the dense (slots, max_len) cache is
    # never allocated, and the engine still serves
    model, params, _ = setup

    def refuse(*a, **kw):
        raise AssertionError("PagedEngine built the dense cache")

    monkeypatch.setattr(engine_mod, "init_cache", refuse)
    eng = PagedEngine(model, params, slots=2, max_len=MAX_LEN, page_size=8,
                      device="cpu")
    assert eng.cache is None
    eng.add_request(Request(0, list(range(2, 9)), max_new=3))
    assert [len(r.out) for r in eng.run_to_completion()] == [3]
    assert eng.pool.n_free == eng.pool.capacity


# ------------------------------------------------ other cache geometries

@pytest.fixture(scope="module")
def ring_setup():
    return _pair("h2o-danube-3-4b")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_ring_sliding_window_paged_matches_dense(ring_setup, temperature):
    """The ring leaf pages too (W = 48 slots of reduced h2o-danube):
    paged equals dense, and greedy equals the reference paged engine."""
    rids = (0, 1, 2, 3)
    dense_out, _ = _serve(ring_setup, Engine, temperature, rids=rids)
    paged_out, eng = _serve(ring_setup, PagedEngine, temperature, rids=rids,
                            page_size=8)
    assert eng.pool.specs[0].ring and eng.pool.specs[0].seq_len == 48
    assert paged_out == dense_out
    if temperature == 0.0:
        want, _ = _serve_ref(ring_setup, JPagedEngine, rids=rids,
                             page_size=8)
        assert paged_out == want


def test_encoder_decoder_rejected_typed():
    model = build_model(dataclasses.replace(
        reduced(get_config("whisper-medium")), vocab_size=64), device="cpu")
    from repro_torch.models import init_model_params
    params = init_model_params(model, 3, device="cpu")
    with pytest.raises(PagedCacheUnsupported, match="enc-dec"):
        PagedEngine(model, params, slots=2, max_len=MAX_LEN, device="cpu")


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_state_rejected_typed(name):
    """Recurrent state (rwkv; zamba2's Mamba2 layers beside its paged-able
    shared-attention K/V) has no sequence axis to page: the port's
    `PagedEngine` refuses the real model at construction, typed, as the
    reference's does."""
    model, params, (jm, jp, compiled) = _pair(name)
    with pytest.raises(PagedCacheUnsupported, match="recurrent"):
        PagedEngine(model, params, slots=2, max_len=MAX_LEN, device="cpu")
    with pytest.raises(PagedCacheUnsupported, match="recurrent"):
        leaf_specs(model, MAX_LEN)
    from repro.serve.errors import PagedCacheUnsupported as JUnsupported
    with pytest.raises(JUnsupported, match="recurrent"):
        JPagedEngine(jm, jp, slots=2, max_len=MAX_LEN, compiled=compiled)


@pytest.fixture(scope="module")
def moe_setup():
    return _pair("deepseek-moe-16b")


@pytest.mark.parametrize("page_size,slots", [(4, 2), (16, 2), (8, 4)])
def test_moe_greedy_tokens_equal_the_reference_paged_engine(
        moe_setup, page_size, slots):
    """Reduced deepseek-moe-16b (a dense first layer, then MoE with 2
    shared experts): the paged prefill's chunks of lanes, pad rows
    included, route through the same capacity groups as the reference's,
    so the greedy tokens, the peak admission and the freed pool are the
    reference `PagedEngine`'s."""
    want, jeng = _serve_ref(moe_setup, JPagedEngine, slots=slots,
                            page_size=page_size)
    got, eng = _serve(moe_setup, PagedEngine, 0.0, slots=slots,
                      page_size=page_size)
    assert got == want
    assert eng.peak_admitted == jeng.peak_admitted
    assert eng.pool.n_free == eng.pool.capacity


def test_paged_engine_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model, params, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        PagePool(model, page_size=8, n_pages=9, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedEngine(model, params, slots=2, max_len=MAX_LEN)
