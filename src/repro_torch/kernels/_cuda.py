"""Build, load and launch the port's hand-written CUDA kernels for Hopper.

Each kernel is one CUDA C++ source with a plain C interface. The module
that launches a kernel declares it here with `declare`: its name, its
source, its entries and the ctypes signatures of its symbols. The graph
kernels are declared in `pipeline/cuda.py`, each standalone kernel in its
own `kernel.py` (`fir`, `fft`, `shuffle`, `rope`, `flash_attention`).

A source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library, at first use, under ``build/repro_torch/<hash>/`` of the checkout
(keyed on the hash of the source and of the headers it may include from
``kernels/csrc/``, so an edit rebuilds), and loaded with `ctypes`.
`build_all` starts one ``nvcc`` per declared source at once. No fast-math:
division, ``sqrtf`` and ``log1pf`` stay IEEE. Nothing here runs
when a module is imported, so the CPU tests can import every module on a
host without ``nvcc`` or a card.

Every launcher checks device, dtype, shape and contiguity, launches on
PyTorch's current stream of the input's device (made current only for
the call), raises when the launch reports an error, and counts the launch
in ``LAUNCHES[kernel][entry]`` — the count a run reads to show which
kernel its path went through.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM_BYTES = 232_448          # per block on sm_90, opt-in dynamic
# headers that sources include by a relative path ("../../csrc/...")
SHARED_CSRC = Path(__file__).resolve().parent / "csrc"


@dataclasses.dataclass(frozen=True)
class Kernel:
    source: Path        # the CUDA C++ source
    entries: tuple      # the entries whose launches are counted
    signatures: dict    # symbol -> (argtypes, restype)


# the declared kernels, and their launches per entry since the last
# `reset_launches`
KERNELS: dict = {}
LAUNCHES: dict = {}


def declare(name: str, source: Path, entries: tuple,
            signatures: dict) -> None:
    """Declare kernel ``name``: its source, its entries and the C
    signatures of its symbols. The source must also export
    ``<name>_error_string(int) -> const char*``."""
    KERNELS[name] = Kernel(Path(source), tuple(entries), dict(signatures))
    LAUNCHES[name] = dict.fromkeys(entries, 0)


def reset_launches() -> None:
    for counts in LAUNCHES.values():
        for e in counts:
            counts[e] = 0


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    seconds: float      # wall time of the nvcc run (0.0 when cached)
    log: str            # nvcc's output (-Xptxas -v: registers, smem)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def build(source: Path) -> Build:
    """Compile one kernel source once per hash of it and the shared
    headers (`SHARED_CSRC`); reuses an existing build of the same."""
    src = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(SHARED_CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = BUILD_ROOT / key[:16]
    lib = out_dir / f"lib{source.stem}.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)             # atomic: concurrent builders agree
    return Build(lib, seconds, proc.stdout + proc.stderr)


def build_all() -> dict:
    """Build every declared kernel's source, one ``nvcc`` per source, all
    started together; returns {kernel: Build}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        futs = {k: pool.submit(build, v.source) for k, v in KERNELS.items()}
        return {k: f.result() for k, f in futs.items()}


@functools.lru_cache(maxsize=None)
def library(kernel: str) -> ctypes.CDLL:
    """The kernel's shared library, built and bound on first use."""
    spec = KERNELS[kernel]
    lib = ctypes.CDLL(str(build(spec.source).path))
    for sym, (args, res) in spec.signatures.items():
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = args, res
    err = getattr(lib, f"{kernel}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def launch(kernel: str, entry: str, x: torch.Tensor, symbol: str,
           *args) -> None:
    """Call ``symbol`` of the kernel's library with ``args`` followed by
    the current stream of ``x``'s device (made current for the call);
    raise on a nonzero return (the launch's ``cudaGetLastError``), else
    count the launch."""
    lib = library(kernel)
    with torch.cuda.device(x.device):
        err = getattr(lib, symbol)(
            *args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = getattr(lib, f"{kernel}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
    LAUNCHES[kernel][entry] += 1


# ---------------------------------------------------------------------------
# Checks shared by the launchers
# ---------------------------------------------------------------------------

def check_smem(kernel: str, nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{kernel}: {what} needs {nbytes} B of shared "
                         f"memory per block, more than {MAX_SMEM_BYTES}")


def check_cuda_input(x: torch.Tensor, dtypes=(torch.float32,)) -> None:
    """``x`` lies on a card and has one of ``dtypes``."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"the kernel takes {names} input, got {x.dtype}")


def check_table(name: str, t: torch.Tensor, device, shape: tuple) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need a contiguous float32 {shape} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def check_out(name: str, t: torch.Tensor, device, shape: tuple,
              dtype) -> None:
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"out[{name!r}]: need contiguous {dtype} {shape} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)}")


def check_frames(x: torch.Tensor, *, window: int, n_frames: int,
                 frame_stride: int, n_slots: int, slot_stride: int,
                 block_frames: int) -> None:
    """Frame f of slot r, ``window`` samples from ``r*slot_stride +
    f*frame_stride``, lies inside ``x``'s storage."""
    if x.stride(-1) != 1:
        raise ValueError("frames must be contiguous along the sample axis")
    last = (n_slots - 1) * slot_stride + (n_frames - 1) * frame_stride + \
        window
    avail = x.untyped_storage().nbytes() // x.element_size() - \
        x.storage_offset()
    if min(n_slots, n_frames, block_frames) < 1 or last > avail or \
            min(slot_stride, frame_stride) < 0:
        raise ValueError(f"frames reach element {last} of {avail}")


def check_retired(retired: torch.Tensor | None, device) -> None:
    if retired is not None and (retired.device != device or
                                retired.dtype != torch.int32 or
                                retired.numel() != 1):
        raise ValueError(f"retired: need a one-element int32 tensor on "
                         f"{device}, got {retired.dtype} "
                         f"{tuple(retired.shape)} on {retired.device}")
