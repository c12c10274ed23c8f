"""Streaming ASR front-end end to end, on the card.

    PYTHONPATH=src python -m repro_torch.launch.asr_frontend
    PYTHONPATH=src python -m repro_torch.launch.asr_frontend --device cpu

The port's counterpart of `examples/asr_frontend.py`: 4 s of a 16 kHz
chirp plus noise (numpy, seed 0) featurized by the registered ``"asr"``
stage graph in one `graph_pipeline_stream` call (the ASR graph kernel,
`kernels/pipeline/csrc/asr_graph.cu`, with in-kernel (512, 160)
framing), then:

* the log-mel against the independent numpy oracle (`asr_reference`:
  ``np.fft.rfft`` with float64 twiddles) within the example's 1e-5 of
  max(1, max |oracle|);
* the kernel-at-a-time baseline `asr_staged` (the FIR and FFT kernels)
  timed beside a second fused call, both printed (no ratio is gated:
  the example's 1.2x is a figure of the TPU it was written for);
* the same audio through `BiosignalStream` with
  ``StreamConfig(graph="asr", batch_windows=32)``, bitwise the one call;
* one `AsrTranscribe` ticket (the first 0.5 s, 8 new tokens) through
  `ServeFrontend` on reduced whisper-medium with vocab 64, parameters
  from seed 3 and an `Engine` of 2 slots, seed 7.

It runs on the card unless ``device="cpu"`` is asked for; asked for the
card on a host without one, it raises. It ends with the example's closing
line, ``asr frontend OK``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.kernels.pipeline.asr import (asr_reference, asr_staged,
                                              make_asr_frontend)
from repro_torch.kernels.pipeline.ops import graph_pipeline_stream
from repro_torch.models import build_model, init_model_params
from repro_torch.serve.engine import Engine
from repro_torch.serve.frontend import AsrTranscribe, ServeFrontend
from repro_torch.serve.stream import BiosignalStream, StreamConfig

SR, WINDOW, HOP = 16000, 512, 160      # whisper-style 32 ms / 10 ms
ORACLE_TOL = 1e-5                      # the example's scale-relative bound
WHISPER_VOCAB, PARAMS_SEED, ENGINE_SEED = 64, 3, 7


def synthetic_utterance(seed: int = 0) -> np.ndarray:
    """The example's 4 s of 16 kHz audio: a 180 Hz chirp rising 60 Hz/s
    under 0.1 of white noise, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR * 4) / SR
    return (np.sin(2 * np.pi * (180 + 60 * t) * t)
            + 0.1 * rng.standard_normal(t.shape[0])).astype(np.float32)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def whisper_model(device):
    """Reduced whisper-medium with the example's vocabulary of 64."""
    cfg = dataclasses.replace(reduced(get_config("whisper-medium")),
                              vocab_size=WHISPER_VOCAB)
    return build_model(cfg, device=device)


def transcribe(audio: torch.Tensor, device, params=None) -> dict:
    """One `AsrTranscribe` ticket over ``audio`` (8 new tokens) through
    `ServeFrontend` on `whisper_model`; ``params`` default to
    `init_model_params` from `PARAMS_SEED` on ``device``."""
    dev = resolve_device(device)
    model = whisper_model(dev)
    if params is None:
        params = init_model_params(model, PARAMS_SEED, device=dev)
    engine = Engine(model, params, slots=2, max_len=64, temperature=0.0,
                    seed=ENGINE_SEED, device=dev)
    front = ServeFrontend(engine=engine)
    ticket = front.submit(AsrTranscribe(0, audio, max_new=8))
    front.run()
    res = ticket.result()
    return {"features": res.features, "tokens": list(res.tokens)}


def run(device="cuda", params=None) -> dict:
    """The example's readings on ``device``; ``params`` are whisper's
    (`transcribe`)."""
    dev = resolve_device(device)
    audio_np = synthetic_utterance()
    audio = torch.as_tensor(audio_np, device=dev)
    app = make_asr_frontend(device=dev)
    out = graph_pipeline_stream("asr", app, audio, window=WINDOW, hop=HOP,
                                outputs=("logmel",))
    ref = asr_reference(app, audio_np, window=WINDOW, hop=HOP)
    err = float(np.abs(out["logmel"].cpu().numpy() - ref["logmel"]).max())
    scale = max(1.0, float(np.abs(ref["logmel"]).max()))

    _sync(dev)
    t0 = time.perf_counter()
    staged = asr_staged(app, audio, window=WINDOW, hop=HOP)
    _sync(dev)
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = graph_pipeline_stream("asr", app, audio, window=WINDOW, hop=HOP,
                                  outputs=("logmel",))
    _sync(dev)
    fused_s = time.perf_counter() - t0

    served = BiosignalStream(app, StreamConfig(
        window=WINDOW, hop=HOP, batch_windows=32, graph="asr",
        outputs=("logmel",))).process(audio)
    ticket = transcribe(audio[: SR // 2], dev, params)
    return {"device": str(dev), "samples": int(audio.shape[0]),
            "logmel": out["logmel"], "oracle_err": err,
            "oracle_scale": scale, "staged": staged, "fused": fused,
            "staged_ms": staged_s * 1e3, "fused_ms": fused_s * 1e3,
            "served": served["logmel"],
            "served_bitwise": bool(torch.equal(served["logmel"],
                                               out["logmel"])),
            "ticket": ticket}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"{r['samples']} samples -> log-mel {tuple(r['logmel'].shape)} "
          f"(filtered-frame write elided) on {r['device']}")
    print(f"log-mel max |fused - oracle| = {r['oracle_err']:.2e} (scale "
          f"{r['oracle_scale']:.3f}, bound {ORACLE_TOL} x scale)")
    print(f"staged {r['staged_ms']:.1f} ms vs fused {r['fused_ms']:.1f} ms "
          f"wall (1 FIR + 1 FFT launch and host-side framing vs one call)")
    print(f"StreamConfig(graph='asr'): {r['served'].shape[0]} frames, "
          f"bit-identical to the one-call kernel: {r['served_bitwise']}")
    t = r["ticket"]
    print(f"ticket done: features {tuple(t['features'].shape)}, decoded ids "
          f"{t['tokens']} (reduced whisper-medium enc-dec)")
    if not r["oracle_err"] < ORACLE_TOL * r["oracle_scale"]:
        raise SystemExit(f"log-mel off the oracle: {r['oracle_err']}")
    if not r["served_bitwise"]:
        raise SystemExit("the served stream differs from the one call")
    print("asr frontend OK")
    return r


if __name__ == "__main__":
    main()
