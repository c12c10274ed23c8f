"""The port's quickstart and ASR front-end entries
(`repro_torch.launch.quickstart`, `repro_torch.launch.asr_frontend`)
against the JAX package's examples, on the CPU, at the examples' sizes.

Each entry's functions run here on CPU tensors (the plain versions of the
FFT, FIR and ASR graph kernels, held to those kernels on the card by
`chip_smoke.py`'s phase Q); the reference's side runs the same steps as
`examples/quickstart.py` and `examples/asr_frontend.py` do, its Pallas
calls in interpret mode. Model parameters are the reference's, drawn from
the examples' seeds and carried into the port by `params_from_numpy`.

What is compared, and why:
* the four shuffle primitives: bitwise (index permutations);
* the real FFT: within `FFT_TOL` of ``np.fft.rfft`` relative to the
  largest bin, as the entry checks itself, and within 1e-5 of that of
  the reference's kernel;
* the simulator's 512-point real FFT: its result, counters and cycles
  bitwise (the same integer machine);
* deepseek-moe-16b's reduced loss: within `LOSS_TOL` of
  `tests/test_torch_train.py` (rtol 1e-5);
* log-mel: within the example's 1e-5 of max(1, max |reference|) of the
  reference's fused call and of the numpy oracle;
* the `AsrTranscribe` ticket: its greedy tokens equal the reference's
  and its features within the log-mel bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archsim.energy import vwr2a_energy_uj as j_energy_uj
from repro.archsim.programs.fft import run_rfft as j_run_rfft
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import shuffle as jshuffle
from repro.kernels.fft.ops import rfft as j_rfft
from repro.kernels.fir.ops import fir as j_fir
from repro.kernels.pipeline.asr import make_asr_frontend as j_asr_frontend
from repro.kernels.pipeline.ops import \
    graph_pipeline_stream as j_graph_pipeline_stream
from repro.models import build_model as j_build_model
from repro.models import init_model_params as j_init_model_params
from repro.serve.engine import Engine as JEngine
from repro.serve.frontend import AsrTranscribe as JAsrTranscribe
from repro.serve.frontend import ServeFrontend as JServeFrontend
from repro.sharding import ctx as jctx
from repro_torch.core.fir import lowpass_taps
from repro_torch.kernels.fft.kernel import FFT_TOL
from repro_torch.launch import asr_frontend, quickstart
from repro_torch.models import params_from_numpy

LOSS_TOL = dict(atol=0.0, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _no_installed_activation_specs():
    """Another file's reference train step may leave activation specs
    installed in this worker; start from none, as a fresh process does."""
    jctx.install(None)


def test_shuffle_section_matches_reference():
    got = quickstart.shuffle_section("cpu")
    a = jnp.arange(8.0)
    b = jnp.arange(8.0) + 100
    want = {"interleave": jshuffle.interleave(a, b)[:8],
            "prune even": jshuffle.prune(a, b, drop="even"),
            "bit_reverse": jshuffle.bit_reverse(a, b, half="lower"),
            "circ shift": jshuffle.circular_shift(a, b, amount=4,
                                                  half="lower")}
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), k)


def test_fft_fir_section_matches_reference():
    x = quickstart.signal_batch()
    np.testing.assert_array_equal(
        x, np.random.default_rng(0).normal(size=(4, 512)).astype(np.float32))
    got = quickstart.fft_fir_section(x, "cpu")
    assert got["rfft_rel_err"] <= FFT_TOL["float32"]
    Xr, Xi = j_rfft(jnp.asarray(x))
    ref = np.fft.rfft(x)
    scale = np.abs(ref).max()
    gr, gi = (t.numpy() for t in got["rfft"])
    assert np.abs((gr + 1j * gi) - (np.asarray(Xr) + 1j * np.asarray(Xi))) \
        .max() / scale < 1e-5
    want = np.asarray(j_fir(jnp.asarray(x), jnp.asarray(lowpass_taps(11))))
    assert got["fir_finite"]
    np.testing.assert_allclose(got["fir"].numpy(), want, rtol=0, atol=1e-6)


def test_archsim_section_matches_reference():
    x = quickstart.signal_batch()
    got = quickstart.archsim_section(x)
    X, counters, cycles = j_run_rfft(512, x[0] * 0.3)
    np.testing.assert_array_equal(got["X"], X)
    assert got["cycles"] == cycles
    assert got["uj"] == float(j_energy_uj(counters))


def test_lm_section_matches_reference():
    jcfg = j_reduced(j_get_config(quickstart.LM_ARCH))
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm)
    batch = {"tokens": jnp.ones(quickstart.LM_BATCH, jnp.int32),
             "labels": jnp.ones(quickstart.LM_BATCH, jnp.int32)}
    want, _ = jax.jit(jm.loss)(jp, batch)
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    model = build_model(reduced(get_config(quickstart.LM_ARCH)),
                        device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    got = quickstart.lm_section("cpu", params)
    np.testing.assert_allclose(got["loss"], float(want), **LOSS_TOL)


def test_quickstart_main_runs_on_the_cpu(capsys):
    r = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    assert "3666" in out and r["device"] == "cpu"


@pytest.fixture(scope="module")
def asr_run():
    """The entry's readings on the CPU, with the reference's whisper
    parameters (seed 3) carried across."""
    jcfg = dataclasses.replace(j_reduced(j_get_config("whisper-medium")),
                               vocab_size=asr_frontend.WHISPER_VOCAB)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=asr_frontend.PARAMS_SEED)
    model = asr_frontend.whisper_model("cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return asr_frontend.run("cpu", params), (jm, jp)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got) - want).max()) <= \
        asr_frontend.ORACLE_TOL * scale


def test_asr_logmel_matches_reference_and_oracle(asr_run):
    r, _ = asr_run
    audio = asr_frontend.synthetic_utterance()
    want = j_graph_pipeline_stream(
        "asr", j_asr_frontend(), audio, window=asr_frontend.WINDOW,
        hop=asr_frontend.HOP, outputs=("logmel",))["logmel"]
    assert tuple(r["logmel"].shape) == tuple(want.shape) == (397, 64)
    _close(r["logmel"].numpy(), want)
    assert r["oracle_err"] < asr_frontend.ORACLE_TOL * r["oracle_scale"]
    assert r["served_bitwise"]
    assert torch.equal(r["fused"]["logmel"], r["logmel"])
    _close(r["staged"]["logmel"].numpy(), want)


def test_asr_ticket_matches_reference(asr_run):
    r, (jm, jp) = asr_run
    audio = asr_frontend.synthetic_utterance()
    engine = JEngine(jm, jp, slots=2, max_len=64, temperature=0.0,
                     seed=asr_frontend.ENGINE_SEED,
                     compiled=JEngine.compile_model(jm))
    front = JServeFrontend(engine=engine)
    ticket = front.submit(JAsrTranscribe(0, audio[: asr_frontend.SR // 2],
                                         max_new=8))
    front.run()
    want = ticket.result()
    assert r["ticket"]["tokens"] == list(want.tokens)
    _close(r["ticket"]["features"].numpy(), want.features)


def test_asr_main_runs_on_the_cpu(capsys):
    asr_frontend.main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("asr frontend OK")


@pytest.mark.parametrize("entry", [quickstart, asr_frontend])
def test_entry_asked_for_the_card_raises_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.run()
