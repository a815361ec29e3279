"""Validation metrics: disparity EPE, outlier rates and D1.

Port of ``multi_view_stereonet_tpu/train/validation.py``: the columns of the
reference's validation.txt (``epoch loss epe outlier_rate1 outlier_rate2
outlier_rate3 d1_all``). EPE = mean |disp_est - disp_true| over valid pixels,
outlier_rateK = the share with an error above K px, D1 = the share above 3 px
and above 5% of the true disparity (KITTI). Disparities come from idepthmaps
through ``geometry.idepth_to_disparity`` at unit baseline, so EPE is in pixels
at the evaluation resolution.
"""

from __future__ import annotations

import torch

from ..geometry import idepth_to_disparity


def disparity_metrics(K, T_right_in_left, idepth_est, idepth_true) -> dict:
    """K, T_right_in_left (B, 4, 4); idepth maps (B, H, W) at one scale. Returns a dict
    of scalar tensors: epe, outlier_rate1/2/3, d1_all."""
    disp_est = idepth_to_disparity(K, T_right_in_left, idepth_est)
    disp_true = idepth_to_disparity(K, T_right_in_left, idepth_true)
    valid = idepth_true > 0
    err = (disp_est - disp_true).abs()
    n = valid.sum().clamp(min=1)

    def rate(mask):
        return (mask & valid).sum() / n

    return {
        "epe": torch.where(valid, err, torch.zeros_like(err)).sum() / n,
        "outlier_rate1": rate(err > 1.0),
        "outlier_rate2": rate(err > 2.0),
        "outlier_rate3": rate(err > 3.0),
        "d1_all": rate((err > 3.0) & (err > 0.05 * disp_true)),
    }
