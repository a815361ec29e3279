"""Colormapped depth visualizations, numpy and PIL only.

A copy of ``multi_view_stereonet_tpu/utils/visualization.py`` (reference
utils/visualization.py:14-135 and the image writers of test.py:74-91), with
a colormap table for when matplotlib is not installed.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

# 16 stops of matplotlib's magma (samples at linspace(0, 1, 16)), linearly
# interpolated between stops.
_MAGMA_STOPS = np.array([
    [0.001462, 0.000466, 0.013866], [0.043830, 0.033830, 0.141886],
    [0.123833, 0.067295, 0.295879], [0.232077, 0.059889, 0.437695],
    [0.341482, 0.080564, 0.492631], [0.445163, 0.122724, 0.506901],
    [0.550287, 0.161158, 0.505719], [0.658483, 0.196027, 0.490253],
    [0.767398, 0.233705, 0.457755], [0.868793, 0.287728, 0.409303],
    [0.944006, 0.377643, 0.365136], [0.981000, 0.498428, 0.369734],
    [0.994738, 0.624350, 0.427397], [0.997228, 0.747981, 0.516859],
    [0.993170, 0.870024, 0.626189], [0.987053, 0.991438, 0.749504],
], dtype=np.float64)


def _magma(values: np.ndarray) -> np.ndarray:
    """values in [0, 1] -> RGB in [0, 1]: matplotlib's magma where matplotlib is
    installed, else the 16-stop table."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        x = np.clip(values, 0.0, 1.0) * (len(_MAGMA_STOPS) - 1)
        i0 = np.floor(x).astype(int)
        i1 = np.minimum(i0 + 1, len(_MAGMA_STOPS) - 1)
        w = (x - i0)[..., None]
        return _MAGMA_STOPS[i0] * (1 - w) + _MAGMA_STOPS[i1] * w
    return plt.get_cmap("magma")(values)[..., :3]


def apply_cmap(data: np.ndarray, vmin=None, vmax=None, cmap=_magma):
    """Normalize to [vmin, vmax] and colormap; returns float RGB."""
    data = np.asarray(data, dtype=np.float64)
    vmin = float(np.min(data)) if vmin is None else vmin
    vmax = float(np.max(data)) if vmax is None else vmax
    scale = max(vmax - vmin, 1e-12)
    return cmap((data - vmin) / scale)


def apply_normal_map(normals: np.ndarray) -> np.ndarray:
    """(H, W, 3) unit normals -> RGB in [0, 1] (reference :66-92)."""
    return (normals + 1.0) * 0.5


def save_idepth_images(output_dir: str, image_idx, idepthmap_est, idepthmap_true):
    """Magma-colormapped est/true idepth jpgs (test.py:74-91)."""
    os.makedirs(output_dir, exist_ok=True)
    vmax = float(np.max(idepthmap_true))
    for tag, data in (("est", idepthmap_est), ("true", idepthmap_true)):
        rgb = apply_cmap(np.squeeze(data), 0.0, vmax)
        img = Image.fromarray(np.uint8(rgb * 255))
        img.save(os.path.join(output_dir, f"idepthmap_{image_idx}_{tag}.jpg"))


def pyramid_collage(pyramid) -> np.ndarray:
    """Lay out a pyramid into one image: level 0 on the left, coarser levels stacked
    to the right."""
    h0, w0 = pyramid[0].shape[:2]
    extra = max((p.shape[1] for p in pyramid[1:]), default=0)
    canvas = np.zeros((h0, w0 + extra, 3), dtype=np.float32)
    canvas[:h0, :w0] = pyramid[0][..., :3]
    y = 0
    for p in pyramid[1:]:
        h, w = p.shape[:2]
        if y + h > h0:
            break
        canvas[y:y + h, w0:w0 + w] = p[..., :3]
        y += h
    return canvas
