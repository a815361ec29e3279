"""Fronto-parallel plane-sweep homographies.

Port of ``multi_view_stereonet_tpu/geometry/homography.py``:
H_{l->r} = K_r (R_{l->r} + t_{l->r} n^T rho) K_l^{-1}, n = +z, rho the
inverse plane depth. The hypothesis axis D is a real tensor axis.
"""

from __future__ import annotations

import torch

from .transforms import mat3_inverse, se3_inverse


def get_fronto_parallel_homography(K_left: torch.Tensor, K_right: torch.Tensor,
                                   T_left_in_right: torch.Tensor,
                                   idepth: torch.Tensor) -> torch.Tensor:
    """Left->right pixel homography for the plane at inverse depth ``idepth``.

    K_left, K_right: (..., 3, 3); T_left_in_right: (..., 4, 4);
    idepth: (...,). Returns (..., 3, 3).
    """
    R = T_left_in_right[..., :3, :3]
    t = T_left_in_right[..., :3, 3]
    tnT = torch.zeros_like(R)
    tnT[..., :, 2] = t * idepth[..., None]  # t n^T rho: only column z
    H = R + tnT
    H = H @ mat3_inverse(K_left)
    return K_right @ H


def create_plane_sweep_homographies(T_right_in_left: torch.Tensor, K: torch.Tensor,
                                    idepth_samples: torch.Tensor) -> torch.Tensor:
    """Homography family for idepth hypotheses.

    T_right_in_left: (B, 4, 4); K: (B, 4, 4) or (B, 3, 3);
    idepth_samples: (B, D). Returns (B, D, 3, 3).
    """
    K3 = K[..., :3, :3]
    T_left_in_right = se3_inverse(T_right_in_left)
    B, D = idepth_samples.shape
    K3b = K3[:, None].expand(B, D, 3, 3)
    Tb = T_left_in_right[:, None].expand(B, D, 4, 4)
    return get_fronto_parallel_homography(K3b, K3b, Tb, idepth_samples)


def incremental_homographies(H_family: torch.Tensor) -> torch.Tensor:
    """H_inc[i] = H[i]^-1 H[i+1]: (B, D, 3, 3) -> (B, D-1, 3, 3)."""
    return mat3_inverse(H_family[:, :-1]) @ H_family[:, 1:]
