"""Device and kernel selection, and the build of the hand-written kernels.

One rule, no knob: a tensor on the card goes to the CUDA kernel, a
tensor on the CPU goes to the kernel's plain PyTorch version.  Entry
points resolve their device with :func:`resolve_device`, which returns
the card unless the caller asked for the CPU by name, and raises when no
card is present — nothing carries on quietly on the CPU.

Kernels are CUDA C++ sources under ``kernels/<name>/csrc/`` with a plain
C interface.  They are compiled with ``nvcc`` for ``sm_90a`` into shared
libraries at first use, into ``build/repro_torch_kernels/`` at the root
of the checkout (ignored by git), and loaded with ``ctypes``.  Every
exported function returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its CUDA source
SOURCES = {
    "rnnt_lattice": _KERNELS_DIR / "rnnt_lattice" / "csrc" / "rnnt_lattice.cu",
    "omp_gram": _KERNELS_DIR / "omp_gram" / "csrc" / "omp_gram.cu",
    "grad_sketch": _KERNELS_DIR / "grad_sketch" / "csrc" / "grad_sketch.cu",
    "rwkv6_wkv": _KERNELS_DIR / "rwkv6_scan" / "csrc" / "rwkv6_wkv.cu",
    "swa_attn": _KERNELS_DIR / "swa_attn" / "csrc" / "swa_attn.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # kernel name -> nvcc's -Xptxas -v report


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> the card (raises without one);
    ``"cpu"`` -> the CPU, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card (the kernel path), False
    when every one lies on the CPU (the plain path); raises on a mix or
    on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def fp32_numerics() -> None:
    """Full fp32 everywhere: no TF32 in matmuls, cuDNN convolutions or
    RNNs (``cudnn.allow_tf32`` defaults to True), matmul precision
    "highest" — the reference's fp32 numerics.  cuDNN also runs only its
    deterministic algorithms, chosen by its heuristics rather than by
    timing (``benchmark`` off): with ``cudnn.deterministic`` False the
    second CRDNN convolution's backward differed from run to run on an
    H100 (its weight gradient, and its data gradient, which reaches
    ``conv0.w`` and ``conv0.b``), so one seed did not give one RNN-T
    training run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc``
    per source, all started together; raises with nvcc's output when one
    fails.  Returns ``{name: library path}``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: str(_lib_path(name)) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built at first use."""
    if name not in _LIBS:
        path = build([name])[name]
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as the C functions
    take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name: str, status: int) -> None:
    """Raise when a launch returned anything but ``cudaSuccess`` (0)."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def check_input(name: str, t: torch.Tensor, ndim: int) -> None:
    """The kernels take contiguous fp32 tensors of a fixed rank on the
    card; anything else is refused here, before a pointer is passed."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
