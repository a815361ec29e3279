"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into a shared library under ``multi_view_stereonet_tpu_torch/
_build/`` (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a stale library is never loaded. A missing ``nvcc`` or a
failed build raises: there is no fallback on a machine with a card.

Routing (``use_kernel``) is by tensor device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the kernel. ``impl="plain"`` forces the
plain version (the on-card comparison); ``impl="kernel"`` forces the
kernel and raises for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
# -fmad=false: no implicit multiply-add contraction, so the coordinate and
# interpolation arithmetic rounds at each step as the plain PyTorch version
# does (an fma in ((gx + 1) * W - 1) moves a 640-wide coordinate by up to
# 6e-5 px). The convs' explicit fmaf calls are unaffected.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
IMPLS = ("auto", "kernel", "plain")

_libs: dict = {}
_lock = threading.Lock()


def use_kernel(impl: str, tensor) -> bool:
    """True when ``tensor`` should go through the CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain":
        return False
    if impl == "kernel" and not tensor.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors, got a tensor on "
                         f"{tensor.device}")
    return tensor.is_cuda


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of multi_view_stereonet_tpu_torch are "
                           "built from source on first use")
    return nvcc


def _sources_digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            h.update(fname.encode())
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        if name in _libs:
            return _libs[name]
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest(name)}.so")
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
            os.replace(tmp, path)
        _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def check_status(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
