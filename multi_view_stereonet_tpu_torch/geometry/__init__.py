"""Camera geometry on tensors: closed-form inverses, homographies, sampling.

Port of ``multi_view_stereonet_tpu.geometry``: the same functions and
layouts (poses and intrinsics (B, 4, 4)), written over torch tensors.
"""

from .transforms import (
    se3_inverse,
    mat3_inverse,
    baseline_norm,
    normalize_baseline,
    scale_intrinsics,
    build_K_pyramid,
)
from .homography import (
    get_fronto_parallel_homography,
    create_plane_sweep_homographies,
    incremental_homographies,
)
from .projection import (
    pixel_grid,
    normalize_pixel_coords,
    backproject_idepthmap,
    project_points,
    disparity_to_idepth,
    idepth_to_disparity,
    project_idepthmap,
    rectified_disparity_to_depth,
)
from .sampling import create_idepth_samples

__all__ = [
    "se3_inverse",
    "mat3_inverse",
    "baseline_norm",
    "normalize_baseline",
    "scale_intrinsics",
    "build_K_pyramid",
    "get_fronto_parallel_homography",
    "create_plane_sweep_homographies",
    "incremental_homographies",
    "pixel_grid",
    "normalize_pixel_coords",
    "backproject_idepthmap",
    "project_points",
    "disparity_to_idepth",
    "idepth_to_disparity",
    "project_idepthmap",
    "rectified_disparity_to_depth",
    "create_idepth_samples",
]
