"""The PyTorch port stands alone: `repro_torch` and `chip_smoke.py` import
neither jax nor anything of the JAX package `repro`, the kernel module
imports on a host without nvcc, and an entry asked for the default
("cuda") device raises on a host without a card instead of moving the
work elsewhere."""
import ast
import copy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_sources():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES[:-1]}
    for need in ("core/biosignal.py", "kernels/pipeline/graph.py",
                 "kernels/_cuda.py", "kernels/pipeline/cuda.py",
                 "kernels/pipeline/asr.py",
                 "kernels/pipeline/ref.py", "kernels/fir/kernel.py",
                 "kernels/fir/ops.py", "kernels/fir/ref.py",
                 "kernels/fft/kernel.py", "kernels/fft/ops.py",
                 "kernels/fft/ref.py", "serve/stream.py",
                 "serve/resident.py", "core/shuffle.py",
                 "kernels/shuffle/kernel.py", "kernels/shuffle/ops.py",
                 "kernels/shuffle/ref.py", "kernels/rope/kernel.py",
                 "kernels/rope/ops.py", "kernels/rope/ref.py",
                 "models/attention.py", "kernels/flash_attention/kernel.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py", "configs/base.py",
                 "configs/qwen1_5_0_5b.py", "models/layers.py",
                 "models/transformer.py", "models/api.py",
                 "serve/engine.py", "launch/serve.py", "serve/paged.py",
                 "serve/engine_fault.py", "serve/frontend.py",
                 "models/moe.py", "models/rwkv.py", "models/mamba.py",
                 "data/pipeline.py", "train/optim.py", "train/compress.py",
                 "train/step.py", "train/loop.py", "checkpoint/ckpt.py",
                 "launch/train.py", "core/autotune.py",
                 "launch/biosignal_app.py", "archsim/__init__.py",
                 "archsim/isa.py", "archsim/machine.py", "archsim/vector.py",
                 "archsim/energy.py", "archsim/programs/__init__.py",
                 "archsim/programs/fir.py", "archsim/programs/fft.py",
                 "archsim/programs/app.py", "launch/quickstart.py",
                 "launch/asr_frontend.py", "launch/mesh.py",
                 "sharding/__init__.py", "sharding/rules.py",
                 "sharding/ctx.py", "sharding/pipeline.py",
                 "serve/step.py", "analysis/__init__.py",
                 "analysis/op_cost.py", "analysis/roofline.py",
                 "launch/dryrun.py", "launch/dryrun_pp.py"):
        assert need in names
    for src in ("pipeline/csrc/biosignal_graph.cu",
                "pipeline/csrc/asr_graph.cu", "fir/csrc/fir.cu",
                "fft/csrc/fft.cu", "shuffle/csrc/shuffle.cu",
                "rope/csrc/rope.cu",
                "flash_attention/csrc/flash_attention.cu"):
        assert (PORT / "kernels" / src).is_file()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_source_imports_no_jax_or_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_import_loads_no_jax_or_reference_modules():
    """Import every module of the port in a fresh interpreter; neither jax
    nor any `repro.` module may end up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.strip().splitlines()
    assert int(n_modules) >= 24
    assert bad == "[]", bad


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core.biosignal import (app_from_numpy, make_app,
                                            synthetic_respiration)
    from repro_torch.core.fir import lowpass_taps
    from repro_torch.kernels.pipeline.asr import make_asr_frontend
    from repro_torch.kernels.pipeline.graph import (get_graph_factory,
                                                    graph_empty_outputs)
    from repro_torch.kernels.pipeline.kernel import empty_outputs
    from repro_torch.serve.resident import ResidentStream
    from repro_torch.serve.stream import BiosignalStream

    with pytest.raises(RuntimeError, match="cuda"):
        make_app()
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic_respiration(1, 4096)
    with pytest.raises(RuntimeError, match="cuda"):
        BiosignalStream()
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentStream()
    with pytest.raises(RuntimeError, match="cuda"):
        app_from_numpy(lowpass_taps(), [[0.0, 0.0]] * 12, [0.0, 0.0])
    with pytest.raises(RuntimeError, match="cuda"):
        empty_outputs(2048, 12, 2, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        graph_empty_outputs(get_graph_factory("asr")(
            make_asr_frontend(device="cpu"))[0], 512, torch.float32)


def test_kernel_wrapper_refuses_cpu_tensors_without_building():
    """The CUDA wrappers check their inputs before they build anything, so
    on a host without nvcc a CPU tensor gets a ValueError, not a build."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fft.kernel import fft_cuda
    from repro_torch.kernels.fir.kernel import fir_cuda
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.pipeline import cuda
    from repro_torch.kernels.rope.kernel import rope_cuda
    from repro_torch.kernels.shuffle.kernel import shuffle_cuda

    before = copy.deepcopy(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.launch_biosignal_graph(
            torch.zeros(4096), entry="stream", window=2048, n_frames=5,
            frame_stride=512, n_slots=1, slot_stride=0, taps=None,
            twiddle_re=None, twiddle_im=None, untangle=None, svm_w=None,
            svm_b=None, fft_size=512, bands=(1,) * 7, prominence=0.3,
            min_distance=15, block_frames=1, out={})
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.launch_asr_graph(
            torch.zeros(4096), entry="ring", window=512, n_frames=5,
            frame_stride=160, n_slots=1, slot_stride=0, taps=None,
            hann=None, twiddles=None, untangle=None, spans=None,
            fft_size=512, block_frames=8, out={})
    with pytest.raises(ValueError, match="CUDA tensor"):
        fir_cuda(torch.zeros(2, 64), [1.0, -0.97])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fft_cuda(torch.zeros(2, 64), torch.zeros(2, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        shuffle_cuda(torch.zeros(2, 64), torch.zeros(2, 64), "interleave")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rope_cuda(torch.zeros(2, 64), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(*(torch.zeros(1, 8, 2, 16),) * 3)
    assert _cuda.LAUNCHES == before
    if not torch.cuda.is_available():
        assert _cuda.build.cache_info().currsize == 0
        assert _cuda.library.cache_info().currsize == 0
