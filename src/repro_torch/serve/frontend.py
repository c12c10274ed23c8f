"""One admission front-end for every traffic class the repo serves (the
port's counterpart of the JAX package's `serve/frontend.py`).

`ServeFrontend` gives LM requests, biosignal streams and transcriptions
ONE verb:

    front = ServeFrontend(engine=eng, scheduler=sched)
    t_lm = front.submit(Request(0, [3, 1, 4], max_new=8))
    t_bio = front.submit(StreamOpen(stream_id="sensor-7", app=app,
                                    cfg=cfg))
    t_asr = front.submit(AsrTranscribe(1, audio))
    front.run()
    tokens = t_lm.result().out       # the finished Request
    stream = t_bio.result()          # the placed BiosignalStream
    asr = t_asr.result()             # AsrResult: log-mel + tokens

Every submission returns a typed `Ticket` (id, class, status, result
accessor); the old entry points remain as `DeprecationWarning` shims
(`Engine.submit`, `ColumnScheduler.open_stream`).

THE ASR CLASS. `AsrTranscribe` is speech work that spans both halves of
the runtime: at dispatch the raw waveform runs through the fused
stage-graph front-end (`kernels/pipeline/ops.py:graph_pipeline_stream`
with the ``"asr"`` graph: on a CUDA waveform one launch of the ASR graph
kernel, `kernels/pipeline/csrc/asr_graph.cu`, with in-kernel framing;
on a CPU waveform its plain version), then a decoder `Request` is
admitted to the enc-dec LM engine; the ticket resolves to an `AsrResult`
pairing the log-mel features with the finished request. A waveform given
as a numpy array is featurized on the engine's device. The features are
not handed to the engine (as in the reference: its enc-dec admission is
token at a time through decode).

ADMISSION POLICY. One arrival-ordered queue for every class; `pump`
drains it by WEIGHTED ROUND-ROBIN over the classes (default ``{"lm": 1,
"stream": 1, "asr": 1}``), so a burst of one class cannot starve the
others: a class of weight w dispatches at most w items per cycle while
another class has work waiting. Downstream backpressure is respected,
not retried: a `QueueFull` from the fault-tolerant engine leaves the
ticket QUEUED for the next pump (an ASR ticket keeps its features for
the retry); a typed rejection (`PromptTooLong`, `InsufficientPages`,
`RequestExpired`, `InsufficientHealthyWorkers`) fails the ticket and
stores the error for `Ticket.result` to re-raise.

RE-PROVISIONING. The classes share one device fleet: `lend_columns`
withdraws the least-loaded stream columns (`ColumnScheduler.withdraw`:
streams drain onto survivors; the device goes to the LM class) and
`return_columns` restores them (`ColumnScheduler.restore`). The
supervision layers ride along unchanged underneath.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.engine import Request
from repro_torch.serve.errors import (QueueFull, RequestExpired, ServeError,
                                      TicketNotReady)

__all__ = ["StreamOpen", "AsrTranscribe", "AsrResult", "Ticket",
           "ServeFrontend"]


@dataclasses.dataclass(frozen=True)
class StreamOpen:
    """The stream-class work item: everything
    `ColumnScheduler.place_stream` needs to admit + construct a
    `BiosignalStream`. The stream-side twin of the LM `Request`."""
    stream_id: object
    app: object = None
    cfg: object = None


@dataclasses.dataclass(frozen=True)
class AsrTranscribe:
    """The asr-class work item: one utterance end to end.

    ``audio`` is the raw 1-D waveform (a float32 tensor, or an array
    placed on the engine's device); at dispatch it is featurized by the
    fused ``"asr"`` stage graph (pre-emphasis FIR -> Hann -> packed rFFT
    power -> log-mel, ONE kernel launch on the card with in-kernel
    (window, hop) framing) and a decoder `Request` — ``prompt`` tokens
    (default ``[0]``, the start-of-transcript placeholder), ``max_new``
    budget — is admitted to the enc-dec engine under the same rid.
    ``app`` is a `kernels/pipeline/asr.py:AsrFrontendApp` (None: the
    graph's default app on the waveform's device: 16 kHz, 512-point FFT,
    64 mels)."""
    rid: int
    audio: object
    window: int = 512
    hop: int = 160
    app: object = None
    max_new: int = 16
    prompt: object = None


@dataclasses.dataclass(frozen=True)
class AsrResult:
    """What an asr-class `Ticket.result` returns: the fused log-mel
    features (n_frames, n_mels) computed at dispatch, paired with the
    finished engine `Request` (decoded ids in ``request.out``)."""
    rid: int
    features: object
    request: object

    @property
    def tokens(self) -> list:
        return self.request.out


@dataclasses.dataclass
class Ticket:
    """Typed handle for one submission, either class.

    ``status`` walks queued -> running -> done (LM work decodes across
    engine steps) or queued -> done (a stream placement is synchronous),
    or lands on failed with the typed rejection stored. `result` is the
    only accessor: the finished `Request` for LM work, the placed
    `BiosignalStream` for stream work; it re-raises the stored error
    for failed tickets and raises `TicketNotReady` before completion."""
    tid: int
    work_class: str                 # "lm" | "stream" | "asr"
    status: str = "queued"
    _result: object = None
    _error: Optional[BaseException] = None

    def result(self):
        if self.status == "failed":
            raise self._error
        if self.status != "done":
            raise TicketNotReady(self.tid, self.status)
        return self._result

    def _finish(self, result) -> None:
        self._result, self.status = result, "done"

    def _fail(self, err: BaseException) -> None:
        self._error, self.status = err, "failed"


class ServeFrontend:
    """The unified front door (see the module docstring).

    ``engine`` serves the LM class (`Engine` or any of its supervised /
    paged subclasses), ``scheduler`` the stream class; either may be
    None when only one class is deployed. ``qos`` maps class name to
    round-robin weight."""

    def __init__(self, *, engine=None, scheduler=None,
                 qos: Optional[dict] = None):
        self.engine = engine
        self.scheduler = scheduler
        self.qos = dict(qos) if qos is not None else \
            {"lm": 1, "stream": 1, "asr": 1}
        if not all(w >= 1 for w in self.qos.values()):
            raise ValueError(f"QoS weights must be >= 1: {self.qos}")
        self.tickets: list[Ticket] = []
        self._pending: list[tuple] = []   # (ticket, work, kwargs)
        self._by_rid: dict = {}           # live LM/ASR rid -> ticket
        self._features: dict = {}         # live ASR rid -> log-mel array
        self.lent: list[tuple] = []       # (column, device) on loan to LM

    # ---------------------------------------------------------- admission

    def submit(self, work, **kwargs) -> Ticket:
        """THE admission verb for every class: an LM `Request`, a
        `StreamOpen`, or an `AsrTranscribe`. Returns the `Ticket`
        immediately; dispatch happens on the next `pump` (so QoS
        weighting sees the whole arrival batch, and downstream
        backpressure never raises out of submit)."""
        if isinstance(work, Request):
            cls = "lm"
            if self.engine is None:
                raise ValueError("no engine configured for LM work")
        elif isinstance(work, StreamOpen):
            cls = "stream"
            if self.scheduler is None:
                raise ValueError("no scheduler configured for stream work")
        elif isinstance(work, AsrTranscribe):
            cls = "asr"
            if self.engine is None:
                raise ValueError("no engine configured for ASR work")
        else:
            raise TypeError(
                f"submit() takes a Request, a StreamOpen, or an "
                f"AsrTranscribe, got {type(work).__name__}")
        t = Ticket(len(self.tickets), cls)
        self.tickets.append(t)
        self._pending.append((t, work, kwargs))
        return t

    def _dispatch(self, ticket: Ticket, work, kwargs) -> None:
        if ticket.work_class == "lm":
            self.engine.add_request(work, **kwargs)
            self._by_rid[work.rid] = ticket
            ticket.status = "running"
        elif ticket.work_class == "asr":
            self._dispatch_asr(ticket, work, kwargs)
        else:
            stream = self.scheduler.place_stream(
                work.app, work.cfg, stream_id=work.stream_id, **kwargs)
            ticket._finish(stream)

    def _dispatch_asr(self, ticket: Ticket, work: AsrTranscribe,
                      kwargs) -> None:
        """Featurize on the fused stage-graph path, then admit the
        decoder request. Features are computed BEFORE `add_request` so
        engine backpressure (`QueueFull`) re-dispatches cheaply: the
        stash under the rid survives and is reused on the retry."""
        if work.rid not in self._features:
            from repro_torch.kernels.pipeline.ops import graph_pipeline_stream

            audio = work.audio
            if not isinstance(audio, torch.Tensor):
                audio = torch.as_tensor(np.asarray(audio, np.float32),
                                        device=self.engine.device)
            feats = graph_pipeline_stream(
                "asr", work.app, audio, window=work.window,
                hop=work.hop, outputs=("logmel",))["logmel"]
            self._features[work.rid] = feats
        prompt = list(work.prompt) if work.prompt is not None else [0]
        self.engine.add_request(Request(work.rid, prompt,
                                        max_new=work.max_new), **kwargs)
        self._by_rid[work.rid] = ticket
        ticket.status = "running"

    def pump(self) -> int:
        """Drain the unified queue by weighted round-robin over the
        classes. Returns the number of submissions dispatched. A
        `QueueFull` leaves the remaining LM tickets queued (backpressure
        — the engine will make room as requests finish); any other
        `ServeError` fails that ticket and keeps pumping."""
        dispatched = 0
        blocked: set[str] = set()
        progress = True
        while progress and len(blocked) < len(self.qos):
            progress = False
            for cls, weight in self.qos.items():
                if cls in blocked:
                    continue
                for _ in range(weight):
                    item = next((p for p in self._pending
                                 if p[0].work_class == cls), None)
                    if item is None:
                        break
                    try:
                        self._dispatch(*item)
                    except QueueFull:
                        blocked.add(cls)
                        break
                    except ServeError as e:
                        item[0]._fail(e)
                        self._features.pop(getattr(item[1], "rid", None),
                                           None)
                    self._pending.remove(item)
                    dispatched += 1
                    progress = True
        return dispatched

    # --------------------------------------------------------- completion

    def _resolve_engine(self, done) -> None:
        for req in done:
            t = self._by_rid.pop(req.rid, None)
            if t is None:
                continue
            if t.work_class == "asr":
                t._finish(AsrResult(req.rid,
                                    self._features.pop(req.rid, None), req))
            else:
                t._finish(req)
        # TTL-shed requests surface as failed tickets, not silent loss
        for req in getattr(self.engine, "expired", ()):
            t = self._by_rid.pop(req.rid, None)
            if t is not None:
                self._features.pop(req.rid, None)
                t._fail(RequestExpired(req.rid, 0.0))

    def run(self, max_steps: int = 1000) -> list[Ticket]:
        """Pump + serve until every LM ticket resolves (stream tickets
        resolve at dispatch). Alternates admission pumps with
        `Engine.run_to_completion` so backpressured tickets re-enter as
        the engine frees queue space. Returns all tickets ever issued."""
        while True:
            n = self.pump()
            inflight = bool(self._by_rid)
            if self.engine is not None and inflight:
                done = self.engine.run_to_completion(max_steps=max_steps)
                self._resolve_engine(done)
            queued = any(t.status == "queued" for t in self.tickets)
            if not queued and not self._by_rid:
                break
            if n == 0 and not inflight:
                break   # wedged: nothing dispatched, nothing in flight
        return list(self.tickets)

    # ----------------------------------------------------- re-provisioning

    def lend_columns(self, n: int = 1) -> list:
        """Withdraw the ``n`` least-loaded healthy stream columns and
        hand their DEVICES to the LM class (the drain moves re-pin the
        columns' streams onto survivors first). The loans stack in
        ``lent`` until `return_columns`."""
        devices = []
        for _ in range(n):
            loads = self.scheduler.loads()
            col = min(self.scheduler.healthy_columns(),
                      key=lambda c: (loads[c], c))
            device, _moves = self.scheduler.withdraw(col)
            self.lent.append((col, device))
            devices.append(device)
        return devices

    def return_columns(self) -> list[int]:
        """Restore every lent column to the stream scheduler (LIFO —
        the reverse of the lend order). Returns the restored columns."""
        restored = []
        while self.lent:
            col, _device = self.lent.pop()
            self.scheduler.restore(col)
            restored.append(col)
        return restored
