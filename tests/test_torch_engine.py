"""The port's continuous-batching `Engine` (`repro_torch.serve.engine`)
against the JAX package's, on the CPU, and its invariants torch against
torch.

* Greedy tokens equal the reference `Engine`'s EXACTLY on
  `tests/test_engine_determinism.py`'s setup: reduced qwen1.5-0.5b with
  vocab 64, the JAX package's parameters of seed 3 carried by
  `params_from_numpy`, its prompts, slots 1-4 and max_len 64 (float32 on
  both sides).
* Sampling cannot reuse the reference's ``fold_in`` keys; the port draws
  each token from a `torch.Generator` seeded by (seed, rid, token index),
  so the reference's placement invariants are pinned torch against
  torch, greedy and at temperature 0.8: slot count, co-tenants and
  submission order do not change a request's tokens; seeds and rids
  give distinct streams; and the sampler draws the categorical of the
  logits.
* The encoder-decoder admission (reduced whisper-medium, vocab 64): one
  decode per prompt token into a copy of the cache, one merge each; its
  greedy tokens equal the reference `Engine`'s, and a live slot's cache
  rows are untouched by another slot's admission.
* The other families (reduced deepseek-moe-16b, rwkv6 and zamba2, vocab
  64, seed 3): greedy tokens equal the reference `Engine`'s at slots 1
  and 4; MoE prompts pad to their bucket, recurrent ones bucket by exact
  length; the merge copies K/V and state along the batch axis. A reused
  slot's recurrent prefill starts from the state its last request left,
  in both packages.
* The admission boundary and the cache merge: `PromptTooLong`,
  `EngineStalled`, the bucket capped at max_len, one prefill per bucket,
  and the slot axis taken from the schema (with num_layers == slots a
  shape probe would merge the layer axis).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.models import init_model_params as j_init_model_params
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import tree_items, tree_map
from repro_torch.serve.engine import Engine, Request, sample_per_request
from repro_torch.serve.errors import EngineStalled, PromptTooLong

PROMPTS = {0: [3, 1, 4, 1], 1: [5, 9, 2], 2: [6, 5], 3: [8, 9, 7, 9, 3],
           4: [2, 3], 5: [4, 6, 2, 6]}


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen1.5-0.5b")),
                               vocab_size=64)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=3)
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              vocab_size=64)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return model, params, (jm, jp, JEngine.compile_model(jm))


def _engine(setup, **kw):
    model, params, _ = setup
    kw.setdefault("max_len", 64)
    return Engine(model, params, device="cpu", **kw)


def _serve(setup, rids, *, slots, temperature, seed=7, max_new=5,
           order=None):
    eng = _engine(setup, slots=slots, temperature=temperature, seed=seed)
    for rid in (order if order is not None else rids):
        eng.add_request(Request(rid, list(PROMPTS[rid]), max_new=max_new))
    done = eng.run_to_completion(max_steps=500)
    assert sorted(r.rid for r in done) == sorted(rids)
    assert all(len(r.out) == max_new and r.done for r in done)
    return {r.rid: tuple(r.out) for r in done}


@pytest.mark.parametrize("slots", [1, 2, 3, 4])
def test_greedy_tokens_equal_the_reference_engine(setup, slots):
    jm, jp, compiled = setup[2]
    ref = JEngine(jm, jp, slots=slots, max_len=64, compiled=compiled)
    for rid in PROMPTS:
        ref.add_request(JRequest(rid, list(PROMPTS[rid]), max_new=5))
    want = {r.rid: tuple(r.out) for r in ref.run_to_completion(500)}
    assert _serve(setup, list(PROMPTS), slots=slots, temperature=0.0) == want


def _slot_counts(setup, temperature):
    ref = _serve(setup, [0, 1, 2, 3], slots=4, temperature=temperature)
    for slots in (1, 2, 3):
        assert _serve(setup, [0, 1, 2, 3], slots=slots,
                      temperature=temperature) == ref


def _cotenants(setup, temperature):
    alone = _serve(setup, [1], slots=2, temperature=temperature)[1]
    pair = _serve(setup, [1, 4], slots=2, temperature=temperature)[1]
    crowd = _serve(setup, list(PROMPTS), slots=2,
                   temperature=temperature)[1]
    assert alone == pair == crowd


def _submission_order(setup, temperature):
    rids = list(PROMPTS)
    ref = _serve(setup, rids, slots=2, temperature=temperature)
    assert _serve(setup, rids, slots=2, temperature=temperature,
                  order=[5, 2, 0, 4, 1, 3]) == ref


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("invariant", [_slot_counts, _cotenants,
                                       _submission_order],
                         ids=["slot_count", "cotenants", "order"])
def test_tokens_invariant_to_placement(setup, invariant, temperature):
    """A request's tokens do not depend on which slot, which co-tenants
    or which admission order it had (tests/test_engine_determinism.py's
    sweeps)."""
    invariant(setup, temperature)


def test_seed_and_rid_separate_streams(setup):
    a = _serve(setup, [0, 1], slots=2, temperature=1.0, seed=7)
    b = _serve(setup, [0, 1], slots=2, temperature=1.0, seed=8)
    assert a != b
    assert a == _serve(setup, [0, 1], slots=2, temperature=1.0, seed=7)
    eng = _engine(setup, slots=2, temperature=1.0, seed=7)
    eng.add_request(Request(10, [3, 1, 4, 1], max_new=8))
    eng.add_request(Request(11, [3, 1, 4, 1], max_new=8))
    done = {r.rid: tuple(r.out) for r in eng.run_to_completion()}
    assert done[10] != done[11]


def test_sampler_draws_the_categorical():
    """Over 4,000 token indices of one request, the Gumbel-max sampler's
    frequencies match softmax(logits) within 4 binomial sigmas, and a
    draw depends on nothing but (seed, rid, step, logits)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]])
    n = 4000
    toks = [int(sample_per_request(3, [9], [s], logits)[0])
            for s in range(n)]
    p = torch.softmax(logits[0], 0).numpy()
    freq = np.bincount(toks, minlength=5) / n
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n)), freq
    again = sample_per_request(3, [9, 9], [17, 17], logits.repeat(2, 1))
    assert again.tolist() == [toks[17], toks[17]]


def test_engine_matches_forward_continuation(setup):
    """Bursty mixed-length admission runs ONE padded prefill per bucket
    (widths 2, 4, 8 for four requests), and every request's greedy
    continuation equals argmax over model.forward on its own sequence
    (tests/test_system.py's bucketed-admission case)."""
    model, params, _ = setup
    prompts = [[3, 1], [7, 2], [4, 1, 5], [9, 2, 6, 5, 3]]
    eng = _engine(setup, slots=4)
    widths = []
    real = eng._prefill_dispatch
    eng._prefill_dispatch = lambda batch: (
        widths.append(batch["tokens"].shape[1]), real(batch))[1]
    for rid, p in enumerate(prompts):
        eng.add_request(Request(rid, p, max_new=3))
    done = {r.rid: r.out for r in eng.run_to_completion()}
    assert sorted(widths) == [2, 4, 8], widths
    for rid, prompt in enumerate(prompts):
        seq = list(prompt)
        for _ in range(3):
            logits, _ = model.forward(params, {"tokens": torch.tensor([seq])})
            seq.append(int(torch.argmax(logits[0, -1])))
        assert done[rid] == seq[len(prompt):], rid


def test_prompt_too_long_at_add_request(setup):
    eng = _engine(setup, slots=2, max_len=8)
    with pytest.raises(PromptTooLong) as ei:
        eng.add_request(Request(0, list(range(1, 11)), max_new=2))
    assert (ei.value.rid, ei.value.n_tokens, ei.value.max_len) == (0, 10, 8)
    eng.add_request(Request(1, [1, 2, 3], max_new=2))
    done = eng.run_to_completion()
    assert [r.rid for r in done] == [1] and len(done[0].out) == 2
    with pytest.warns(DeprecationWarning):
        eng.submit(Request(2, [1, 2], max_new=1))
    assert [r.rid for r in eng.run_to_completion()] == [2]


def test_stall_raises_with_unfinished_rids(setup):
    eng = _engine(setup, slots=1)
    eng.add_request(Request(0, [1, 2], max_new=2))
    eng.add_request(Request(1, [3, 4], max_new=30))
    with pytest.raises(EngineStalled) as ei:
        eng.run_to_completion(max_steps=4)
    assert ei.value.unfinished == [1]
    assert [r.rid for r in ei.value.done] == [0]


def test_bucket_capped_at_max_len(setup):
    """A prompt whose next power of two exceeds max_len still admits, in a
    bucket of max_len rows, and its tokens are the reference engine's."""
    eng = _engine(setup, slots=2, max_len=12)
    assert [eng._length_bucket(n) for n in (1, 2, 3, 5, 9, 12)] == \
        [1, 2, 4, 8, 12, 12]
    eng.add_request(Request(0, list(range(1, 10)), max_new=2))
    done = eng.run_to_completion()
    jm, jp, compiled = setup[2]
    ref = JEngine(jm, jp, slots=2, max_len=12, compiled=compiled)
    ref.add_request(JRequest(0, list(range(1, 10)), max_new=2))
    assert done[0].out == ref.run_to_completion()[0].out


def _snapshot(eng, slot):
    """Slot ``slot``'s rows of every cache leaf (axis from the schema)."""
    return [leaf.select(ax, slot).clone() for (_, leaf), (_, ax) in
            zip(tree_items(eng.cache), tree_items(eng._slot_axes))]


def test_partial_admission_leaves_live_slots_untouched(setup):
    """num_layers == slots == 2: a request admitted into slot 1 while slot
    0 decodes must not touch slot 0's cache (a merge along the layer axis,
    which a shape probe would pick, would), and the non-admitted slot's
    rows stay bitwise as they were; the tokens are the reference's."""
    model = setup[0]
    assert model.cfg.num_layers == 2
    eng = _engine(setup, slots=2)
    assert all(ax == 1 for _, ax in tree_items(eng._slot_axes))
    eng.add_request(Request(0, [3, 1, 4, 1], max_new=6))
    eng.step()
    eng.step()
    before0 = _snapshot(eng, 0)
    eng.add_request(Request(1, [5, 9, 2], max_new=3))
    eng._admit()
    assert eng.live[1] is not None
    for a, b in zip(before0, _snapshot(eng, 0)):
        assert torch.equal(a, b)
    done = {r.rid: r.out for r in eng.run_to_completion()}
    jm, jp, compiled = setup[2]
    ref = JEngine(jm, jp, slots=2, max_len=64, compiled=compiled)
    ref.add_request(JRequest(0, [3, 1, 4, 1], max_new=6))
    ref.step()
    ref.step()
    ref.add_request(JRequest(1, [5, 9, 2], max_new=3))
    want = {r.rid: r.out for r in ref.run_to_completion()}
    assert done == want


def test_prefill_rows_of_other_slots_stay_bitwise(setup):
    """The prefill computes every slot's rows (a fresh cache, as the
    reference's); the merge copies only the admitted slot's, so a free
    slot's stale rows and the caller-visible live cache are untouched by
    the prefill itself."""
    eng = _engine(setup, slots=3)
    gen = torch.Generator().manual_seed(0)
    eng.cache = tree_map(lambda t: torch.randn(t.shape, generator=gen),
                         eng.cache)
    before = [_snapshot(eng, s) for s in range(3)]
    live = tree_map(torch.clone, eng.cache)
    seen = {}
    real = eng._prefill_dispatch

    def spy(batch):
        out = real(batch)
        seen["unchanged"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_items(eng.cache), tree_items(live)))
        return out
    eng._prefill_dispatch = spy
    eng.add_request(Request(0, [6, 5, 4], max_new=1))
    eng.live[0] = Request(99, [1], max_new=1)     # slot 0 busy: admit to 1
    eng._admit()
    assert seen["unchanged"]
    assert eng.lens[1] == 3 and eng.live[1].rid == 0
    for s in (0, 2):
        for a, b in zip(before[s], _snapshot(eng, s)):
            assert torch.equal(a, b), s
    assert not all(torch.equal(a, b) for a, b in
                   zip(before[1], _snapshot(eng, 1)))


def test_serve_cli_runs_in_process(capsys):
    done = serve_cli.main(["--reduced", "--device", "cpu", "--requests",
                           "3", "--max-new", "4", "--slots", "2"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 4 for r in done)
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out and "tok/s on cpu" in out


def test_engine_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model, params, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(model, params, slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(model, params, slots=2, max_len=16, device="cuda")


# ---------------------------------------------------------------------------
# Encoder-decoder: token-at-a-time admission
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encdec():
    jcfg = dataclasses.replace(j_reduced(j_get_config("whisper-medium")),
                               vocab_size=64)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=3)
    cfg = dataclasses.replace(reduced(get_config("whisper-medium")),
                              vocab_size=64)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return model, params, (jm, jp, JEngine.compile_model(jm))


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_encdec_greedy_tokens_equal_the_reference_engine(encdec, slots):
    jm, jp, compiled = encdec[2]
    ref = JEngine(jm, jp, slots=slots, max_len=64, compiled=compiled)
    for rid in PROMPTS:
        ref.add_request(JRequest(rid, list(PROMPTS[rid]), max_new=5))
    want = {r.rid: tuple(r.out) for r in ref.run_to_completion(500)}
    assert _serve(encdec, list(PROMPTS), slots=slots,
                  temperature=0.0) == want


def test_encdec_admission_leaves_live_slots_untouched(encdec):
    """Admitting a request into slot 1 runs one full-slot decode per
    prompt token; slot 0, decoding meanwhile, keeps every cache row
    bitwise, and the tokens are the reference's for the same schedule."""
    eng = _engine(encdec, slots=2)
    eng.add_request(Request(0, [3, 1, 4, 1], max_new=6))
    eng.step()
    eng.step()
    before0 = _snapshot(eng, 0)
    eng.add_request(Request(1, [5, 9, 2], max_new=3))
    eng._admit()
    assert eng.lens[1] == 3 and eng.live[1].rid == 1
    for a, b in zip(before0, _snapshot(eng, 0)):
        assert torch.equal(a, b)
    done = {r.rid: r.out for r in eng.run_to_completion()}
    jm, jp, compiled = encdec[2]
    ref = JEngine(jm, jp, slots=2, max_len=64, compiled=compiled)
    ref.add_request(JRequest(0, [3, 1, 4, 1], max_new=6))
    ref.step()
    ref.step()
    ref.add_request(JRequest(1, [5, 9, 2], max_new=3))
    assert done == {r.rid: r.out for r in ref.run_to_completion()}


# ---------------------------------------------------------------------------
# The other families: MoE (padded buckets), RWKV-6 and the Mamba2 hybrid
# (recurrent state, exact-length buckets)
# ---------------------------------------------------------------------------

ENGINE_FAMILIES = ["deepseek-moe-16b", "rwkv6-7b", "zamba2-7b"]


@pytest.fixture(scope="module", params=ENGINE_FAMILIES)
def family(request):
    """(port model, params, (JAX model, params, compiled pair)) of a
    reduced config of ``name`` with vocab 64, the JAX package's
    parameters of seed 3 carried across."""
    name = request.param
    jcfg = dataclasses.replace(j_reduced(j_get_config(name)), vocab_size=64)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=3)
    cfg = dataclasses.replace(reduced(get_config(name)), vocab_size=64)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return model, params, (jm, jp, JEngine.compile_model(jm))


@pytest.mark.parametrize("slots", [1, 4])
def test_family_greedy_tokens_equal_the_reference_engine(family, slots):
    """Six requests through slots 1 and 4: a slot is reused, so a
    recurrent prefill starts from the state its slot's last request left
    (the reference's prefill reads the engine cache as its initial
    state, and so does the port's)."""
    jm, jp, compiled = family[2]
    ref = JEngine(jm, jp, slots=slots, max_len=64, compiled=compiled)
    for rid in PROMPTS:
        ref.add_request(JRequest(rid, list(PROMPTS[rid]), max_new=5))
    want = {r.rid: tuple(r.out) for r in ref.run_to_completion(500)}
    assert _serve(family, list(PROMPTS), slots=slots,
                  temperature=0.0) == want


def test_family_buckets_and_merge(family):
    """MoE pads prompts to their power-of-two bucket; recurrent state
    buckets by exact length. Admission copies the admitted slots' rows of
    every cache leaf (K/V and state) along the schema's batch axis and
    leaves a decoding slot's rows bitwise."""
    model, params, _ = family
    eng = _engine(family, slots=3)
    widths = []
    real = eng._prefill_dispatch
    eng._prefill_dispatch = lambda batch: (
        widths.append(batch["tokens"].shape[1]), real(batch))[1]
    eng.add_request(Request(0, [3, 1, 4, 1, 5], max_new=6))
    eng.step()
    before0 = _snapshot(eng, 0)
    eng.add_request(Request(1, [5, 9, 2], max_new=3))
    eng.add_request(Request(2, [6, 5, 3], max_new=3))
    eng._admit()
    for a, b in zip(before0, _snapshot(eng, 0)):
        assert torch.equal(a, b)
    recurrent = model.cfg.ssm is not None
    assert eng._pad_ok() is not recurrent
    assert widths == ([5, 3] if recurrent else [8, 4]), widths
    eng.run_to_completion()
