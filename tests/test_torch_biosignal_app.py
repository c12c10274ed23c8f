"""The port's application entry (`repro_torch.launch.biosignal_app`)
against the JAX package's own functions, on the CPU.

`run("cpu")` at 10 windows' worth of signal (37 overlapping frames, the
example's 40 cut for time) is held to what `examples/biosignal_app.py`
computes with the reference, on the same numpy inputs:

* the staged app (`BiosignalApp.__call__`) on the host-framed signal:
  the window count and classes exactly, the margins to the tolerances of
  `tests/test_torch_stream.py` (rtol 1e-5, atol 1e-4);
* `svm_fit_least_squares` on the features of the 64 labelled windows:
  w and b within `SVM_FIT_RTOL` of `tests/test_torch_core.py` (a float32
  solve of a normal matrix of condition ~8e8 through two LAPACKs), the
  holdout classes and the accuracy exactly;
* `archsim.programs.app.run_app` on the first labelled window x 0.5 with
  the reference's own fit: the cycles of every stage, the uJ and the
  savings exactly (the simulator's program does not depend on the
  weights' values).
"""
import jax
import numpy as np
import pytest
import torch

from repro.archsim.energy import vwr2a_energy_uj as j_energy_uj
from repro.archsim.programs.app import run_app as j_run_app
from repro.core import biosignal as jbio
from repro.core.fir import fir_direct as j_fir_direct
from repro.core.fir import lowpass_taps as j_lowpass_taps
from repro.serve.stream import frame_signal as j_frame_signal
from repro_torch.launch import biosignal_app as bapp

N_WINDOWS = 10
SVM_FIT_RTOL = 1e-2


@pytest.fixture(scope="module")
def result():
    return bapp.run("cpu", N_WINDOWS)


@pytest.fixture(scope="module")
def reference():
    long_sig = np.asarray(jbio.synthetic_respiration(
        1, 2048 * N_WINDOWS, seed=3)[0][0])
    japp = jbio.make_app()
    staged = jax.jit(japp.__call__)(j_frame_signal(long_sig, 2048, 512))
    sig, labels = jbio.synthetic_respiration(64, 2048, seed=3)
    taps = j_lowpass_taps(11)
    feats = jax.jit(lambda s: jbio.extract_features(
        j_fir_direct(s, taps)))(sig)
    w, b = jbio.svm_fit_least_squares(feats[:32], labels[:32])
    _, pred = jbio.svm_predict(feats[32:], w, b)
    acc = float((pred == labels[32:]).mean())
    sim = j_run_app(np.asarray(sig[0]) * 0.5, taps, np.asarray(w),
                    np.asarray(b))
    return {"staged": {k: np.asarray(v) for k, v in staged.items()},
            "w": np.asarray(w), "b": np.asarray(b), "pred": np.asarray(pred),
            "acc": acc, "sim": sim, "window": np.asarray(sig[0])}


def test_stream_matches_reference_staged_app(result, reference):
    want = reference["staged"]
    assert result["windows"] == want["class"].shape[0] == 37
    assert result["samples"] == 2048 * N_WINDOWS
    np.testing.assert_array_equal(result["class"].numpy(), want["class"])
    np.testing.assert_allclose(result["margin"].numpy(), want["margin"],
                               rtol=1e-5, atol=1e-4)
    assert result["outputs"] == ["class", "features", "margin"]
    # the example's own bounds, and bitwise within the port on the CPU
    assert result["staged_err"] < bapp.STAGED_TOL
    assert result["column_err"] < bapp.COLUMN_TOL
    assert result["staged_err"] == result["column_err"] == \
        result["host_err"] == 0.0
    assert result["windows_per_s"] > 0 and result["host_windows_per_s"] > 0


def test_svm_fit_matches_reference(result, reference):
    for got, want in ((result["w"], reference["w"]),
                      (result["b"], reference["b"])):
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SVM_FIT_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(result["holdout_pred"].numpy(),
                                  reference["pred"])
    assert result["accuracy"] == reference["acc"]


def test_archsim_matches_reference(result, reference):
    sim, want = result["archsim"], reference["sim"]
    assert sim["stage_cycles"] == {k: want[k][1] for k in bapp.STAGES}
    assert sim["cycles"] == sum(want[k][1] for k in bapp.STAGES)
    assert sim["uj"] == sum(j_energy_uj(want[k][0]) for k in bapp.STAGES)
    assert sim["prediction"] == want["prediction"]
    assert sim["cycle_saving"] == 1 - sim["cycles"] / 166667
    assert 0 < sim["energy_saving"] < 1
    # the port's own fit gives the same counters (the program does not
    # depend on the weights' values)
    again = bapp.archsim_window(reference["window"] * 0.5, reference["w"],
                                reference["b"])
    assert again["cycles"] == sim["cycles"] and again["uj"] == sim["uj"]


def test_autotune_winners_are_reported(result):
    keys = {tuple(t["key"][:1]) for t in result["autotune"]}
    assert keys == {("biosignal_pipeline_stream",), ("biosignal_pipeline",)}
    for t in result["autotune"]:
        assert t["winner"] in t["candidates"] and t["search_ms"] >= 0
        if t["ms"] is not None:
            assert t["clock"] == "host"
            assert len(t["ms"]) == len(t["spread"]) == len(t["candidates"])
    lines = bapp.report(result)
    assert any(line.startswith("VWR2A: ") for line in lines)
    assert sum(line.startswith("autotune ") for line in lines) == 2


def test_run_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        bapp.run()
    with pytest.raises(RuntimeError, match="cuda"):
        bapp.main([])


def test_main_prints_the_example_lines(capsys):
    r = bapp.main(["--device", "cpu", "--windows", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "biosignal app OK"
    assert r["windows"] == 13
