"""Build, load and launch `csrc/biosignal_graph.cu`, the fused biosignal
graph kernel for Hopper.

The source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/repro_torch/<hash>/``
of the checkout (keyed on the source's hash, so an edit rebuilds), and
loaded with `ctypes`. No fast-math: division, ``sqrtf`` and ``log1pf`` stay
IEEE. Nothing here runs when the module is imported, so the CPU tests can
import it on a host without ``nvcc`` or a card.

`launch_biosignal_graph` checks device, dtype, shape, contiguity and the
frame extents, launches on PyTorch's current stream of the input's
device (made current only for the call), raises when the launch reports
an error, and counts the launch in `LAUNCHES` under its entry
(``"frames"``, ``"stream"`` or ``"ring"``) — the count a run reads to
show that its path went through the kernel.
"""
from __future__ import annotations

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "biosignal_graph.cu"
BUILD_ROOT = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM_BYTES = 232_448          # per block on sm_90, opt-in dynamic

# output selection bits, as in the source
_OUT_BITS = {"filtered": 1, "features": 2, "margin": 4, "class": 8}

# launches per entry since the last `reset_launches`
LAUNCHES = {"frames": 0, "stream": 0, "ring": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
def build() -> Build:
    """Compile the kernel library once per source hash; reuses an
    existing build of the same source."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = BUILD_ROOT / key[:16]
    lib = out_dir / "libbiosignal_graph.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)             # atomic: concurrent builders agree
    return Build(lib, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.biosignal_graph_launch.argtypes = [
        p, ll, ll, i, i, i, i,                     # x, framing
        p, i, p, p, p, i,                          # taps, fft tables
        p, p, i, i, ctypes.POINTER(ctypes.c_int),  # svm, sizes, bands
        f, i,                                      # delineation
        p, p, p, p,                                # outputs
        p, i, i, p]                                # retire, flags, stream
    lib.biosignal_graph_launch.restype = ctypes.c_int
    lib.biosignal_graph_smem_bytes.argtypes = [i, i]
    lib.biosignal_graph_smem_bytes.restype = ctypes.c_size_t
    lib.biosignal_graph_error_string.argtypes = [i]
    lib.biosignal_graph_error_string.restype = ctypes.c_char_p
    return lib


def _check_table(name: str, t: torch.Tensor, device, shape: tuple) -> None:
    if t.device != device or t.dtype != torch.float32 or \
            not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need a contiguous float32 {shape} tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def launch_biosignal_graph(x: torch.Tensor, *, entry: str, window: int,
                           n_frames: int, frame_stride: int, n_slots: int,
                           slot_stride: int, taps, twiddle_re, twiddle_im,
                           untangle, svm_w, svm_b, fft_size: int,
                           bands: tuple, prominence: float,
                           min_distance: int, block_frames: int,
                           out: dict, retired: torch.Tensor | None = None,
                           valid_rows: int | None = None) -> None:
    """Run the graph on ``n_slots * n_frames`` frames of ``x`` (frame f of
    slot r starts ``r*slot_stride + f*frame_stride`` elements past
    ``x``'s first element) and write the outputs present in ``out``
    (flat (n_slots * n_frames, ...) tensors) in place. ``retired``, a
    one-element int32 tensor on the card, receives from the kernel the
    number of frames it wrote among the first ``valid_rows`` (default:
    all)."""
    if entry not in LAUNCHES:
        raise ValueError(f"unknown entry {entry!r}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {dev}")
    if x.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32 input, got {x.dtype}")
    if x.stride(-1) != 1:
        raise ValueError("frames must be contiguous along the sample axis")
    last = (n_slots - 1) * slot_stride + (n_frames - 1) * frame_stride + \
        window
    avail = x.untyped_storage().nbytes() // 4 - x.storage_offset()
    if min(n_slots, n_frames, block_frames) < 1 or last > avail or \
            min(slot_stride, frame_stride) < 0:
        raise ValueError(f"frames reach element {last} of {avail}")
    m = fft_size // 2
    C = svm_w.shape[-1]
    _check_table("taps", taps, dev, (taps.shape[0],))
    _check_table("twiddle_re", twiddle_re, dev, (m.bit_length() - 1, m // 2))
    _check_table("twiddle_im", twiddle_im, dev, (m.bit_length() - 1, m // 2))
    _check_table("untangle", untangle, dev, (2, m))
    _check_table("svm_w", svm_w, dev, (12, C))
    _check_table("svm_b", svm_b, dev, (C,))
    rows = n_slots * n_frames
    want = {"filtered": ((rows, window), torch.float32),
            "features": ((rows, 12), torch.float32),
            "margin": ((rows, C), torch.float32),
            "class": ((rows,), torch.int32)}
    flags = 0
    ptrs = {}
    for name, t in out.items():
        shape, dt = want[name]
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"out[{name!r}]: need contiguous {dt} {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)}")
        flags |= _OUT_BITS[name]
        ptrs[name] = t.data_ptr()
    if not flags:
        raise ValueError("no outputs requested")
    if valid_rows is None:
        valid_rows = rows
    if retired is not None and (retired.device != dev or
                                retired.dtype != torch.int32 or
                                retired.numel() != 1):
        raise ValueError(f"retired: need a one-element int32 tensor on "
                         f"{dev}, got {retired.dtype} "
                         f"{tuple(retired.shape)} on {retired.device}")
    lib = _library()
    smem = lib.biosignal_graph_smem_bytes(window, fft_size)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"window {window} needs {smem} B of shared memory "
                         f"per block, more than {MAX_SMEM_BYTES}")
    band_arr = (ctypes.c_int * 7)(*bands)
    with torch.cuda.device(dev):
        err = lib.biosignal_graph_launch(
            x.data_ptr(), slot_stride, frame_stride, n_slots, n_frames,
            window, block_frames, taps.data_ptr(), taps.shape[0],
            twiddle_re.data_ptr(), twiddle_im.data_ptr(), untangle.data_ptr(),
            fft_size, svm_w.data_ptr(), svm_b.data_ptr(), svm_w.shape[0], C,
            band_arr, prominence, min_distance, ptrs.get("filtered"),
            ptrs.get("features"), ptrs.get("margin"), ptrs.get("class"),
            None if retired is None else retired.data_ptr(),
            min(max(valid_rows, 0), rows), flags,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"biosignal_graph launch failed: "
            f"{lib.biosignal_graph_error_string(err).decode()} ({err})")
    LAUNCHES[entry] += 1
