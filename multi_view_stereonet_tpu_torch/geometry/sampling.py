"""Data-dependent inverse-depth hypothesis grids.

Port of ``multi_view_stereonet_tpu/geometry/sampling.py``.
"""

from __future__ import annotations

import torch

from .projection import disparity_to_idepth


def create_idepth_samples(T_right_in_left: torch.Tensor, K: torch.Tensor,
                          rows: int, cols: int, num_idepth_samples: int) -> torch.Tensor:
    """Per-batch linear idepth grid from 0 to a geometry-derived maximum.

    The maximum is the mean over valid pixels of the idepth of the largest
    representable disparity (num_samples - 1), clamped to <= 2 and to stay
    in front of the right camera (1 / tz). A map with no valid pixel gives
    NaN, as the reference does.

    T_right_in_left: (B, 4, 4) unit-baseline pose; K: (B, 4, 4).
    Returns (B, num_idepth_samples).
    """
    B = T_right_in_left.shape[0]
    dtype, device = T_right_in_left.dtype, T_right_in_left.device

    max_disp = torch.full((B, rows, cols), float(num_idepth_samples - 1),
                          dtype=dtype, device=device)
    max_idepthmap = disparity_to_idepth(K, T_right_in_left, max_disp)
    max_idepthmap = torch.where(max_idepthmap > 0, max_idepthmap,
                                torch.zeros_like(max_idepthmap))

    flat = max_idepthmap.reshape(B, -1)
    total = torch.sum(flat, dim=1)
    count = torch.sum(flat > 0, dim=1).to(dtype)
    # NaN stays NaN; a minimum, as the JAX package's, passes half the gradient at a tie.
    max_idepths = torch.minimum(total / count, total.new_full((), 2.0))

    tz = T_right_in_left[:, 2, 3]
    behind = (1.0 / max_idepths) < tz
    max_idepths = torch.where(behind, 1.0 / tz, max_idepths)

    steps = torch.arange(num_idepth_samples, dtype=dtype, device=device)
    delta = max_idepths / (num_idepth_samples - 1)
    return steps[None, :] * delta[:, None]
