"""Measured block-size autotuning for the port's kernels.

Each hand-written kernel has a launch knob that changes its speed and
never its result: the frames a CUDA block runs in the two graph kernels
(`kernels/pipeline/csrc/*.cu`), the rows a block runs in the standalone
FIR and FFT (`kernels/{fir,fft}/csrc/*.cu`), and the ring depth of the
resident loop (`serve/resident.py`). This module times a few candidate
values on the caller's real tensors, keeps the fastest, and caches the
winner per (kernel, shape) key, so the search is paid once per process.

The cache keys, the candidate ring depths and the JSON artifact
(`save_cache` / `load_cache`) are those of the JAX package's
`core/autotune.py`: the same call leaves the same key in both, and a file
written by either loads in the other. What differs is the clock and the
candidates:

* `_measure` times a call with CUDA events when its output lies on a
  card, with ``time.perf_counter`` when it lies on the CPU; one untimed
  call first builds the kernel and warms the caches. One search reads
  all its candidates on one clock: behind a device sleep that hides the
  host's enqueue when every candidate's is short (device time alone),
  else as they run, host gaps in (always for the ring depth; see
  `autotune_block_rows`);
* the candidate blocks come from each kernel's own launch rules (its
  default, its thread bound), not from a TPU sublane or VMEM budget.

Every search is logged (`search_log`): the candidates' best times and
the spread of their reps, the winner and the search's host cost.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable

import torch

# (kernel-name, shape...) -> winning block_rows
_CACHE: dict[tuple, int] = {}
# pinned-shape perf records: name -> {"us", "spread", ...} — the paired
# rep measurements a cross-commit gate compares
_PINNED: dict[str, dict] = {}
# key -> the last search under that key (see `search_log`)
_SEARCHES: dict[tuple, dict] = {}


def clear_cache() -> None:
    _CACHE.clear()
    _PINNED.clear()
    _SEARCHES.clear()


def cache_snapshot() -> dict:
    return dict(_CACHE)


def search_log() -> dict:
    """key -> {"candidates", "ms" (best of the reps each), "spread"
    ((median - min) / min each), "clock" ("cuda" or "host"), "host_gaps"
    (whether the readings hold the host's time between launches; one
    value for all candidates), "winner", "search_ms" (host wall of the
    whole search, warm calls included)} for every search this process ran
    since `clear_cache`."""
    return {k: dict(v) for k, v in _SEARCHES.items()}


def _spread(ts) -> float:
    ts = sorted(ts)
    return (ts[len(ts) // 2] - ts[0]) / max(ts[0], 1e-9)


def record_pinned(name: str, times_us: list, *,
                  baseline_us: list | None = None) -> dict:
    """Record a pinned benchmark shape's paired-rep timings for a
    cross-commit gate.

    ``times_us`` are the per-rep times of the pinned configuration;
    ``baseline_us`` (optional) a PAIRED sibling timed alternately in the
    same rep loop. A gate compares the ratio baseline/us when a baseline
    exists (absolute times of two machines are not comparable; a same-run
    paired ratio is), with the tolerance taken from the run's own rep
    spread. Spread is (median - min)/min — robust to the occasional
    outlier rep that would otherwise blow the tolerance wide open.
    """
    best = min(times_us)
    rec = {"us": best, "spread": _spread(times_us), "reps": len(times_us)}
    if baseline_us is not None:
        rec["ratio"] = min(baseline_us) / max(best, 1e-9)
        rec["spread"] = max(rec["spread"], _spread(baseline_us))
    _PINNED[name] = rec
    return rec


def _freeze(x):
    """JSON round-trip: lists (de)serialize to tuples, recursively — cache
    keys are nested tuples like (name, rows, window, hop, outputs, dtype)."""
    return tuple(_freeze(v) for v in x) if isinstance(x, (list, tuple)) else x


def save_cache(path: str) -> int:
    """Persist the winners as a JSON artifact so later processes
    warm-start instead of re-measuring. Pinned-shape perf records
    (`record_pinned`) ride along. Returns the winner entry count."""
    entries = [{"key": list(k), "block_rows": v}
               for k, v in sorted(_CACHE.items(), key=lambda kv: str(kv[0]))]
    with open(path, "w") as f:
        json.dump({"autotune_winners": entries, "pinned": dict(_PINNED)},
                  f, indent=1, default=list)
    return len(entries)


def load_cache(path: str) -> int:
    """Warm-start the in-process cache from a `save_cache` artifact.
    Missing file is not an error (first run of a fresh checkout). Pinned
    perf records are deliberately NOT loaded — they must be re-measured
    every run, or a cross-commit gate would compare an artifact against a
    copy of itself. Returns the number of loaded winner entries."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        data = json.load(f)
    entries = data.get("autotune_winners", [])
    for e in entries:
        _CACHE[_freeze(e["key"])] = int(e["block_rows"])
    return len(entries)


def dtype_name(dtype) -> str:
    """A tensor dtype as the cache keys spell it ("float32", as numpy and
    JAX print it)."""
    return str(dtype).removeprefix("torch.")


def _pow2_pool(limit: int, default: int, max_candidates: int) -> list[int]:
    """The kernel's default (capped by ``limit``) and the powers of two up
    to ``limit`` nearest it in octaves, at most ``max_candidates``,
    largest first."""
    limit = max(int(limit), 1)
    default = min(max(int(default), 1), limit)
    pool = {default} | {1 << i for i in range(limit.bit_length())}
    near = sorted(pool, key=lambda c: (abs(c.bit_length() -
                                           default.bit_length()), c))
    return sorted(near[:max_candidates], reverse=True)


def candidate_block_rows(rows: int, *, default: int = 1,
                         max_rows: int | None = None,
                         max_candidates: int = 4) -> list[int]:
    """Candidate row-blocks for an R-row operand of the FIR or the FFT:
    the kernel's ``default`` and the powers of two nearest it, up to R and
    ``max_rows`` (the FFT's: `fft/kernel.py:MAX_THREADS` over its threads
    a row; a block past it does not launch). Both grids pad the last block,
    so a candidate need not divide R, and a row's result never depends on
    the rows beside it in its block."""
    limit = rows if max_rows is None else min(rows, max_rows)
    return _pow2_pool(limit, default, max_candidates)


def _cuda_output(out) -> torch.Tensor | None:
    """The first CUDA tensor in a call's result (a tensor, or a dict,
    tuple or list holding some), or None."""
    if isinstance(out, torch.Tensor):
        return out if out.device.type == "cuda" else None
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (tuple, list)) else ()
    for v in items:
        t = _cuda_output(v)
        if t is not None:
            return t
    return None


# a search whose calls all take less than this of host enqueue is timed
# behind a device sleep that covers them (device time alone); a search
# with a longer call, or one that trades host gaps, as its calls run
SLEEP_COVER_S = 5e-3


def _warm(fn: Callable[[], object]) -> tuple[torch.device | None, float]:
    """One untimed call of ``fn``, which also builds the kernel at first
    use. When its output lies on a card, one more call whose host enqueue
    is timed (the events do not see it): (device, enqueue seconds); on
    the CPU (None, 0.0)."""
    t = _cuda_output(fn())
    if t is None:
        return None, 0.0
    dev = t.device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return dev, enqueue


def _measure(fn: Callable[[], object], reps: int,
             dev: torch.device | None, cover_s: float) -> list:
    """Per-rep ms of ``fn`` (already warm). On the card (``dev``) the
    clock is a pair of CUDA events around the call on its device's
    current stream, each rep queued behind a device sleep of ``cover_s``
    seconds when that is not 0: the events then read the card's time for
    the launches alone, with no host gap between them. On the CPU
    (``dev`` None) the clock is ``time.perf_counter``."""
    times = []
    if dev is not None:
        stream = torch.cuda.current_stream(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if cover_s:
                with torch.cuda.device(dev):
                    torch.cuda._sleep(int(2e9 * cover_s))
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            times.append(float(start.elapsed_time(end)))
        return times
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def autotune_block_rows(key: tuple, candidates: list[int],
                        build: Callable[[int], Callable[[], object]],
                        *, reps: int = 3, host_gaps: bool = False) -> int:
    """Pick the fastest `block_rows` among `candidates`.

    ``build(rb)`` returns a zero-arg callable running the kernel with that
    block size; every candidate is warmed once (`_warm`), then each is
    timed best-of-`reps` (`_measure`) on one clock for the whole search,
    so no two candidates are read on different clocks. A call of a few
    small launches spends more time on the host than on the card (a B=8
    dispatch: ~0.17 ms of host against a ~0.008 ms kernel), so when every
    candidate's host enqueue is under `SLEEP_COVER_S` each rep is queued
    behind a device sleep twice the longest enqueue and the search reads
    device time alone. Otherwise, or with ``host_gaps`` (a knob that
    trades launches against the host's time between them, as the ring
    depth does), every candidate is timed as it runs, its host gaps in
    the reading. The winner is cached under ``key`` for the life of the
    process and the search is logged (`search_log`).
    """
    if key in _CACHE:
        return _CACHE[key]
    if len(candidates) == 1:
        _CACHE[key] = candidates[0]
        return candidates[0]
    t0 = time.perf_counter()
    fns = [build(rb) for rb in candidates]
    warm = [_warm(fn) for fn in fns]
    dev, enqueue = warm[0][0], max(e for _, e in warm)
    gaps = dev is None or host_gaps or enqueue >= SLEEP_COVER_S
    cover_s = 0.0 if gaps else 2 * enqueue + 1e-4
    runs = [_measure(fn, reps, dev, cover_s) for fn in fns]
    best = min((min(ts), rb) for ts, rb in zip(runs, candidates))[1]
    _CACHE[key] = best
    _SEARCHES[key] = {
        "candidates": list(candidates),
        "ms": [min(ts) for ts in runs],
        "spread": [_spread(ts) for ts in runs],
        "clock": "host" if dev is None else "cuda", "host_gaps": gaps,
        "winner": best, "search_ms": (time.perf_counter() - t0) * 1e3}
    return best


def tuned_block_rows(name: str, rows: int, extras: tuple,
                     run: Callable[[int], object], *,
                     candidates: list[int] | None = None) -> int:
    """One-call wiring for the kernel `ops` wrappers: build the per-shape
    cache key (name, rows, *extras), take the kernel's ``candidates``
    (default `candidate_block_rows(rows)`), measure, cache. ``run(rb)``
    executes the kernel with that block size."""
    key = _freeze((name, rows) + tuple(extras))
    return autotune_block_rows(
        key, candidates if candidates is not None
        else candidate_block_rows(rows), lambda rb: lambda: run(rb))


def candidate_stream_block_frames(n_frames: int, window: int, hop: int,
                                  *, default: int = 1,
                                  max_frames: int | None = None,
                                  max_candidates: int = 4) -> list[int]:
    """Candidate frame-blocks for a graph kernel over ``n_frames`` frames
    of a (window, hop) signal: the kernel's ``default`` and the powers of
    two nearest it, up to ``n_frames`` and the kernel's ``max_frames``.
    The biosignal kernel (default 1) runs min(block_frames, 4) frame
    groups of 128 threads at once and the ASR kernel (default 8) as many
    frames of fft_size / 32 threads as fit 512; both loop over the rest
    of a block's frames. Neither has the reference's window - hop overlap
    floor (the card reads each frame's window from device memory, so
    ``window`` and ``hop`` bound nothing), and neither result depends on
    the block."""
    limit = n_frames if max_frames is None else min(n_frames, max_frames)
    return _pow2_pool(limit, default, max_candidates)


def tuned_stream_block_frames(name: str, n_frames: int, window: int,
                              hop: int, outputs: tuple, dtype: str,
                              run: Callable[[int], object],
                              n_columns: int = 1,
                              shares: tuple | None = None, *,
                              default: int = 1,
                              max_frames: int | None = None) -> int:
    """`tuned_block_rows` for the raw-signal graph entries: the cache key
    carries the full (window, hop, outputs) shape — the same window batch
    tuned for classification-only traffic (no `filtered` write) may
    legitimately pick a different block than the all-outputs variant —
    plus the column count when dealt (`n_columns > 1`): each column runs
    only ~n_frames/D frames, so the right block is per-(shape, D). A
    non-uniform deal additionally carries its share signature
    (``shares``, the `column_shares` frame counts): a winner measured on
    a (9, 19, 18, 18) deal must not leak onto the (16,)*4 equal deal.
    Candidates are enumerated over the WIDEST per-column share — the
    column that bounds the dispatch's time."""
    sig = () if shares is None else ("w",) + tuple(shares)
    key = _freeze((name, n_frames, window, hop, outputs, dtype)
                  + ((n_columns,) if n_columns > 1 else ()) + sig)
    per_col = max(shares) if shares is not None else -(-n_frames // n_columns)
    return autotune_block_rows(
        key, candidate_stream_block_frames(
            max(per_col, 1), window, hop, default=default,
            max_frames=max_frames),
        lambda rb: lambda: run(rb))


def candidate_ring_depths(n_batches: int, *,
                          max_candidates: int = 4) -> list[int]:
    """Candidate ring depths (chunks per sweep) for the resident loop:
    powers of two up to the batch count — a deeper ring launches fewer,
    larger sweeps but pads more tail batches."""
    pool = {d for d in (1, 2, 4, 8, 16) if d <= max(n_batches, 1)}
    pool.add(1)
    return sorted(pool, reverse=True)[:max_candidates]


def tuned_ring_depth(name: str, window: int, hop: int, batch_windows: int,
                     outputs: tuple, dtype: str, drain_interval: int,
                     n_batches: int, run: Callable[[int], object]) -> int:
    """Measured ring depth for `serve.resident.ResidentStream`. The cache
    key carries the full dispatch shape (window, hop, batch_windows,
    outputs, dtype), the DRAIN INTERVAL (draining every sweep makes
    shallow rings pay a counter readback more often, so the winner is
    per-interval), and the batch count (a 4-batch signal cannot justify a
    16-deep ring). ``run(rd)`` executes one full resident loop at that
    ring depth. The search always reads the loop as it runs, host gaps
    between launches in: fewer launches is what a deeper ring buys."""
    key = _freeze((name, window, hop, batch_windows, outputs, dtype,
                   drain_interval, n_batches))
    return autotune_block_rows(key, candidate_ring_depths(n_batches),
                               lambda rd: lambda: run(rd), host_gaps=True)
