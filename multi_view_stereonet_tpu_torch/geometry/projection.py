"""Pixel grids, back-projection and the epipolar disparity <-> inverse-depth maps.

Port of ``multi_view_stereonet_tpu/geometry/projection.py``. Pixel convention: grid_sample-normalized coordinates
put (-1, -1) at the top-left corner of the top-left pixel,
x' = 2 (x + 0.5) / cols - 1.
"""

from __future__ import annotations

import torch

from .transforms import mat3_inverse, se3_inverse


def pixel_grid(rows: int, cols: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates, (3, rows, cols) with planes [x, y, 1]."""
    y = torch.arange(rows, dtype=dtype, device=device)[:, None].expand(rows, cols)
    x = torch.arange(cols, dtype=dtype, device=device)[None, :].expand(rows, cols)
    ones = torch.ones((rows, cols), dtype=dtype, device=device)
    return torch.stack([x, y, ones], dim=0)


def normalize_pixel_coords(uv: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Pixel coordinates (..., 2), x then y, to grid_sample-normalized ones in [-1, 1]."""
    x = 2.0 * (uv[..., 0] + 0.5) / cols - 1.0
    y = 2.0 * (uv[..., 1] + 0.5) / rows - 1.0
    return torch.stack([x, y], dim=-1)


def backproject_idepthmap(K: torch.Tensor, idepthmap: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """Back-project an inverse depthmap into homogeneous points.

    K: (B, 4, 4) or (B, 3, 3); idepthmap: (B, rows, cols). Returns (B, 4, rows*cols)
    in xyzw, at depth 1 / (idepth + eps).
    """
    B, rows, cols = idepthmap.shape
    depth = 1.0 / (idepthmap + eps)
    Kinv3 = mat3_inverse(K[:, :3, :3])
    pix = pixel_grid(rows, cols, idepthmap.dtype, idepthmap.device).reshape(3, -1)
    xyz = (Kinv3 @ pix) * depth.reshape(B, 1, -1)
    ones = torch.ones((B, 1, rows * cols), dtype=idepthmap.dtype, device=idepthmap.device)
    return torch.cat([xyz, ones], dim=1)


def project_points(K: torch.Tensor, Tinv: torch.Tensor, image_size, points: torch.Tensor,
                   eps: float = 1e-7) -> torch.Tensor:
    """Project homogeneous points (B, 4, N) through K @ Tinv (both (B, 4, 4)) into an
    image of ``image_size`` (rows, cols), N = rows * cols. Returns grid_sample-normalized
    coordinates (B, rows, cols, 2)."""
    rows, cols = image_size
    P = (K @ Tinv)[:, :3, :]
    cam = P @ points
    uv = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    uv = uv.reshape(uv.shape[0], 2, rows, cols).movedim(1, -1)
    return normalize_pixel_coords(uv, rows, cols)


def project_idepthmap(K: torch.Tensor, T_right_in_left: torch.Tensor,
                      left_idepthmap: torch.Tensor, eps: float = 1e-6):
    """Project a left inverse depthmap (B, rows, cols) into the right camera.

    Returns (right pixels (B, rows, cols, 2) normalized, right idepths (B, rows, cols),
    invalid (B, rows, cols): True where a pixel lands outside [-1, 1])."""
    B, rows, cols = left_idepthmap.shape
    T_left_in_right = se3_inverse(T_right_in_left)
    points = backproject_idepthmap(K, left_idepthmap, eps)
    right_pts = T_left_in_right[:, :3, :] @ points
    right_idepths = (1.0 / (right_pts[:, 2, :] + eps)).reshape(B, rows, cols)
    right_pixels = project_points(K, T_left_in_right, (rows, cols), points)
    invalid = (right_pixels[..., 0].abs() > 1.0) | (right_pixels[..., 1].abs() > 1.0)
    return right_pixels, right_idepths, invalid


def rectified_disparity_to_depth(K: torch.Tensor, T_right_in_left: torch.Tensor,
                                 left_disparity: torch.Tensor,
                                 eps: float = 1e-7) -> torch.Tensor:
    """Rectified disparity (B, rows, cols) to depth: fx * ||t|| / disparity."""
    fx = K[:, 0, 0][:, None, None]
    t = T_right_in_left[:, :3, 3]
    baseline = torch.sqrt(torch.sum(t * t, dim=-1))[:, None, None]
    return fx * baseline / (left_disparity + eps)


def idepth_to_disparity(K: torch.Tensor, T_right_in_left: torch.Tensor,
                        left_idepthmap: torch.Tensor) -> torch.Tensor:
    """Inverse depth -> general disparity: the distance in the right image between a
    pixel's projection and its projection at infinite depth.

    K, T_right_in_left: (B, 4, 4); left_idepthmap: (B, rows, cols) -> (B, rows, cols).
    """
    B, rows, cols = left_idepthmap.shape
    pix = pixel_grid(rows, cols, left_idepthmap.dtype, left_idepthmap.device).reshape(3, -1)
    Kinv = mat3_inverse(K[:, :3, :3])
    T_left_in_right = se3_inverse(T_right_in_left)
    KRKinv = K[:, :3, :3] @ (T_left_in_right[:, :3, :3] @ Kinv)
    pix_inf = KRKinv @ pix
    pix_inf = pix_inf / pix_inf[:, 2:3, :]
    points = backproject_idepthmap(K, left_idepthmap)
    right_pix = K[:, :3, :3] @ (T_left_in_right[:, :3, :] @ points)
    diff = right_pix[:, :2, :] / right_pix[:, 2:3, :] - pix_inf[:, :2, :]
    return torch.sqrt(torch.sum(diff ** 2, dim=1)).reshape(B, rows, cols)


def disparity_to_idepth(K: torch.Tensor, T_right_in_left: torch.Tensor,
                        left_disparity: torch.Tensor) -> torch.Tensor:
    """General (non-rectified) disparity -> inverse depth.

    Per pixel, the 1-D least squares along the epipolar line (oriented far
    -> near), with degenerate epilines and 0/0 solves masked to 0.
    K, T_right_in_left: (B, 4, 4); left_disparity: (B, rows, cols).
    Returns (B, rows, cols).
    """
    B, rows, cols = left_disparity.shape
    N = rows * cols
    pix = pixel_grid(rows, cols, left_disparity.dtype,
                     left_disparity.device).reshape(3, N)

    Kinv = mat3_inverse(K[:, :3, :3])
    T_left_in_right = se3_inverse(T_right_in_left)
    R_lr = T_left_in_right[:, :3, :3]
    KRKinv = K[:, :3, :3] @ (R_lr @ Kinv)  # (B, 3, 3)
    KRKinv3 = KRKinv[:, 2, :]
    Kt = (K[:, :4, :4] @ T_left_in_right)[:, :3, 3]  # (B, 3)

    disp = left_disparity.reshape(B, N)

    def mat_pix(M, px, py, s=1.0):  # (B,3,3) x [px, py, s] -> 3 x (B, N)
        return tuple((M[:, i, 0:1] * px + M[:, i, 1:2] * py) + M[:, i, 2:3] * s
                     for i in range(3))

    px, py = pix[0], pix[1]
    inf0, inf1, inf2 = mat_pix(KRKinv, px, py)
    pix_inf = torch.stack([inf0 / inf2, inf1 / inf2], dim=1)  # (B, 2, N)

    far0, far1, far2 = mat_pix(KRKinv, px * 1e2, py * 1e2, 1e2)
    far0 = far0 + Kt[:, 0:1]
    far1 = far1 + Kt[:, 1:2]
    far2 = far2 + Kt[:, 2:3]
    pix_far = torch.stack([far0 / far2, far1 / far2], dim=1)

    epi_diff = pix_far - pix_inf
    epi_norm = torch.sqrt(torch.sum(epi_diff ** 2, dim=1))  # (B, N)
    epiline = epi_diff / (epi_norm[:, None, :] + 1e-6)
    valid = epi_norm >= 1e-6

    w = (KRKinv3[:, 0:1] * pix[None, 0, :] + KRKinv3[:, 1:2] * pix[None, 1, :]
         + KRKinv3[:, 2:3])
    A0 = Kt[:, 0:1] - Kt[:, 2:3] * (pix_inf[:, 0, :] + disp * epiline[:, 0, :])
    A1 = Kt[:, 1:2] - Kt[:, 2:3] * (pix_inf[:, 1, :] + disp * epiline[:, 1, :])
    b0 = w * disp * epiline[:, 0, :]
    b1 = w * disp * epiline[:, 1, :]
    ATA = A0 * A0 + A1 * A1
    ATb = A0 * b0 + A1 * b1

    # A fully degenerate solve (zero baseline) can leave epi_norm just
    # above the mask threshold with ATA exactly 0: make the denominator
    # safe and mask it too, so the 0/0 never reaches the output.
    safe = ATA > 0
    idepth = torch.where(valid & safe,
                         ATb / torch.where(safe, ATA, torch.ones_like(ATA)),
                         torch.zeros_like(ATA))
    return idepth.reshape(B, rows, cols)
