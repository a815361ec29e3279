"""Host-side (numpy, non-differentiable) depthmap geometry.

Counterpart of the reference utils/depthmap_utils.py (L1b layer): used by
dataset curation and disparity ground-truth generation, not by the
compiled compute path.
"""

from __future__ import annotations

import numpy as np


def rectified_disparity_to_depth(fx, baseline, disparity, eps=1e-7):
    """depth = fx * B / disparity (reference :11-21)."""
    return fx * baseline / (disparity + eps)


def depth_to_rectified_disparity(fx, baseline, depth, eps=1e-7):
    """disparity = fx * B / depth (reference :23-34)."""
    return fx * baseline / (depth + eps)


def depthmap_to_point_cloud(K, depthmap):
    """Back-project valid pixels to 3-D points (N, 3) (reference :65-94)."""
    assert K.shape == (3, 3)
    rows, cols = depthmap.shape
    us, vs = np.meshgrid(range(cols), range(rows))
    flat = depthmap.flatten()
    mask = (flat > 0.0) & ~np.isnan(flat)

    uvw = np.stack([us.flatten(), vs.flatten(), np.ones(rows * cols)], axis=1)
    uvw = uvw[mask]
    depths = flat[mask]

    points = (np.linalg.inv(K) @ uvw.T).T
    return points * depths[:, None]


def point_cloud_to_depthmap(shape, P, T, points):
    """Project points into a camera at pose T; nearest-pixel z-buffer-less
    fill (last write wins, as in the reference :96-147)."""
    assert P.shape == (4, 4) and T.shape == (4, 4)
    Tinv = np.linalg.inv(T)
    hom = np.concatenate(
        [points, np.ones((points.shape[0], 1), np.float32)], axis=1)
    cam = (Tinv @ hom.T).T
    cam = cam[cam[:, 2] > 0]
    pix = (P @ cam.T).T
    xy = pix[:, :2] / pix[:, 2:3]
    xyi = (xy + 0.5).astype(np.int32)

    ok = ((xyi[:, 0] >= 0) & (xyi[:, 1] >= 0)
          & (xyi[:, 0] < shape[1]) & (xyi[:, 1] < shape[0]))
    xyi = xyi[ok]
    depths = cam[ok, 2]

    depthmap = np.zeros(shape, dtype=np.float32)
    depthmap[xyi[:, 1], xyi[:, 0]] = depths
    return depthmap


def depthmap_to_disparity(K, T_right_in_left, depthmap):
    """General (non-rectified) disparity ||u' - u_inf|| (reference :149-202)."""
    Kinv = np.linalg.inv(K)
    T_left_in_right = np.linalg.inv(T_right_in_left)
    KRKinv = K @ T_left_in_right[:3, :3] @ Kinv

    rows, cols = depthmap.shape
    us, vs = np.meshgrid(range(cols), range(rows))
    mask_map = (depthmap > 0.0) & ~np.isnan(depthmap)
    mask = mask_map.flatten()

    uvw = np.stack([us.flatten(), vs.flatten(), np.ones(rows * cols)], axis=1)
    uvw = uvw[mask]
    depths = depthmap.flatten()[mask]

    pix_inf = (KRKinv @ uvw.T).T
    pix_inf = pix_inf[:, :2] / pix_inf[:, 2:3]

    pts = (Kinv @ uvw.T).T * depths[:, None]
    hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    right = (T_left_in_right @ hom.T).T
    rpix = (K @ right[:, :3].T).T
    rpix = rpix[:, :2] / rpix[:, 2:3]

    disparity = np.zeros(depthmap.shape, dtype=np.float64)
    disparity[mask_map] = np.sqrt(np.sum((rpix - pix_inf) ** 2, axis=1))
    return disparity


def resize_sparse_depthmap(shape_new, K_new, K, depthmap):
    """Resize a sparse depthmap by reprojection (reference :204-220)."""
    points = depthmap_to_point_cloud(K, depthmap)
    P = np.eye(4)
    P[:3, :3] = K_new
    return point_cloud_to_depthmap(shape_new, P, np.eye(4), points)
