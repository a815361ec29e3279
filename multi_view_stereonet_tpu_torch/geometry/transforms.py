"""SE(3) / intrinsics helpers with closed-form inverses.

Port of ``multi_view_stereonet_tpu/geometry/transforms.py``: the SE(3)
inverse is a transpose, the 3x3 inverse the adjugate, so no batched LU
solve runs on the device. Poses and intrinsics are (..., 4, 4) float32.
"""

from __future__ import annotations

import torch


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms [[R, t], [0, 1]]: (..., 4, 4) -> (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -(Rt @ t[..., None])
    top = torch.cat([Rt, t_inv], dim=-1)
    # Built on the device: a host constant here would be a blocking copy
    # (and a stream sync) on every call of the serving path.
    bottom = torch.zeros_like(T[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat3_inverse(H: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices via the adjugate."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]

    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C

    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def baseline_norm(T_right_in_left: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the translation: (..., 4, 4) -> (...,)."""
    t = T_right_in_left[..., :3, 3]
    return torch.sqrt(torch.sum(t * t, dim=-1))


def normalize_baseline(T_right_in_left: torch.Tensor):
    """Scale the translation to unit norm; returns (T_normalized, baseline)."""
    b = baseline_norm(T_right_in_left)
    T = T_right_in_left.clone()
    T[..., :3, 3] = T_right_in_left[..., :3, 3] / b[..., None]
    return T, b


def scale_intrinsics(K: torch.Tensor, x_factor: float, y_factor: float) -> torch.Tensor:
    """Rescale intrinsics for an image resize, c' = s (c + 0.5) - 0.5."""
    K = K.clone()
    K[..., 0, 0] = K[..., 0, 0] * x_factor
    K[..., 1, 1] = K[..., 1, 1] * y_factor
    K[..., 0, 2] = x_factor * (K[..., 0, 2] + 0.5) - 0.5
    K[..., 1, 2] = y_factor * (K[..., 1, 2] + 0.5) - 0.5
    return K


def build_K_pyramid(K: torch.Tensor, sizes) -> list:
    """Per-level intrinsics for an image pyramid; ``sizes`` level 0 first."""
    rows0, cols0 = sizes[0]
    out = [K]
    for rows, cols in sizes[1:]:
        out.append(scale_intrinsics(K, float(cols) / cols0, float(rows) / rows0))
    return out
