"""Seeding, device timing, parameter counts and profiler traces.

Port of ``multi_view_stereonet_tpu/utils/timing.py`` (reference
utils/pytorch_utils.py:15-61) in PyTorch terms: ``device_timer`` times the
work queued on the current CUDA stream with CUDA events, and reads the wall
clock on the CPU, where PyTorch runs synchronously.
"""

from __future__ import annotations

import contextlib
import os
import random
import time

import numpy as np
import torch


def set_seeds(seed: int) -> torch.Generator:
    """Seed python and numpy; return a ``torch.Generator`` seeded the same for model code."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


class device_timer:
    """``with device_timer(device) as t: ...`` then ``t.ms``: on a CUDA device, the time
    between events recorded on its current stream at entry and exit (the exit waits for
    the end event); on the CPU, the wall clock."""

    def __init__(self, device="cuda"):
        self._device = torch.device(device)

    def __enter__(self):
        if self._device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._device.type == "cuda":
            self._end.record(torch.cuda.current_stream(self._device))
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """A ``torch.profiler`` trace of the block, every activity this build supports
    (CPU, and CUDA where PyTorch has it), written to ``<log_dir>/trace.json`` as a
    Chrome trace (Perfetto or chrome://tracing open it); nothing when ``log_dir`` is
    empty."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=list(torch.profiler.supported_activities())) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
