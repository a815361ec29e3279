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

Each kernel's launch code (check the inputs, allocate the outputs, launch, count
the launch) is also the CUDA body of a ``torch.library`` custom op of the
namespace ``mvs_torch`` (``custom_op``), with a fake implementation that gives
its output shapes, so that ``torch.export`` records the kernel in a graph
(``checkpoint/export.py``) where it could not see a ctypes call. The wrappers
call the op while ``torch.export`` traces (``tracing``), and the launch code
directly otherwise: the dispatcher adds ~20 us of host a call (PERF.md), and
the serving forward is bound by its host.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
# -fmad=false: no implicit multiply-add contraction, so the coordinate and
# interpolation arithmetic rounds at each step as the plain PyTorch version
# does (an fma in ((gx + 1) * W - 1) moves a 640-wide coordinate by up to
# 6e-5 px). The convs' explicit fmaf calls are unaffected.
# -I: the csrc/*.cuh headers, also for a copy of a source built elsewhere.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC_DIR)
IMPLS = ("auto", "kernel", "plain")
NAMESPACE = "mvs_torch"
# The custom ops, "<NAMESPACE>::<name>" -> the csrc/<source>.cu each launches.
OP_SOURCES: dict = {}

_libs: dict = {}
_lock = threading.Lock()
# (device index, stream) -> the grid-barrier counter of the cooperative launches (K3, K4)
# on that stream
_barriers: dict = {}


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


def load_libraries(*names: str) -> list:
    """Build the missing ``csrc/<name>.cu`` libraries, one nvcc each, all started
    together, then load them; cached per process."""
    with _lock:
        missing = [n for n in dict.fromkeys(names) if n not in _libs]
        if missing:
            os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {n: os.path.join(BUILD_DIR, f"lib{n}-{_sources_digest(n)}.so")
                 for n in missing}
        builds = {}
        try:
            for n, path in paths.items():
                if not os.path.exists(path):
                    tmp = f"{path}.{os.getpid()}.tmp"
                    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
                    builds[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True), tmp)
            failed = []
            for n, (proc, tmp) in builds.items():
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {n}.cu:\n{err}")
                else:
                    os.replace(tmp, paths[n])
        finally:
            for proc, _ in builds.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("\n".join(failed))
        for n, path in paths.items():
            _libs[n] = ctypes.CDLL(path)
        return [_libs[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_libraries(name)[0]


def needs_autograd(*tensors) -> bool:
    """True when grad mode is on and any of ``tensors`` (None skipped) requires grad:
    the wrappers then go through their Function, and launch the kernel directly
    otherwise."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def launch_device(device: torch.device):
    """The context of a ctypes launch on ``device``'s tensors: that card made current
    where it is not. The kernels launch through the runtime on the thread's current
    card (and set their attributes there), whatever card their tensors are on, so a
    process whose tensors are on another card would fail at launch."""
    if device.index == torch._C._cuda_getDevice():  # cheaper than current_device()
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_status(name: str, status: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")


def tracing() -> bool:
    """True while ``torch.export`` (or ``torch.compile``) traces: tensors are fake then,
    so nothing made from them may be cached for a later eager call."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def custom_op(name: str, source: str):
    """``custom_op(name, source)(launch)``: the custom op ``mvs_torch::<name>`` whose
    CUDA implementation is ``launch``, the launch code of ``csrc/<source>.cu``. Register
    its fake implementation with ``register_fake`` on the result."""
    qualname = f"{NAMESPACE}::{name}"
    OP_SOURCES[qualname] = source
    return torch.library.custom_op(qualname, mutates_args=(), device_types="cuda")


def barrier_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The grid-barrier counter (csrc/grid_sync.cuh ``grid_barrier``) of the cooperative
    launches on ``stream``, K3's and K4's alike: zeroed once, and left ready for the next
    launch by every launch, whichever way its top bit stands. Launches on one stream run
    one at a time, so they share it; two streams never do. A launch captured in a CUDA
    graph keeps its capture stream's counter (one made during capture is zeroed by that
    graph at each replay), so graphs captured on one stream are replayed one at a time."""
    key = (device.index, stream)
    counter = _barriers.get(key)
    if counter is None:
        counter = _barriers[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter
