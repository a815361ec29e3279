"""Depth prediction metrics (monodepth/KITTI protocol), numpy only.

A copy of ``multi_view_stereonet_tpu/eval/metrics.py``. Reference: test.py:41-71
(abs_rel, sq_rel, rmse, rmse_log, a1/a2/a3 with delta < 1.25^k) and the
averaging helper test.py:146-164.
"""

from __future__ import annotations

import numpy as np


def get_depth_prediction_metrics(depthmap_true: np.ndarray,
                                 depthmap_est: np.ndarray) -> dict:
    """Metrics over pre-masked (1-D) true/estimated depths."""
    thresh = np.maximum(depthmap_true / depthmap_est,
                        depthmap_est / depthmap_true)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())

    rmse = float(np.sqrt(((depthmap_true - depthmap_est) ** 2).mean()))
    rmse_log = float(np.sqrt(
        ((np.log(depthmap_true) - np.log(depthmap_est)) ** 2).mean()))
    abs_rel = float(np.mean(
        np.abs(depthmap_true - depthmap_est) / depthmap_true))
    sq_rel = float(np.mean(
        ((depthmap_true - depthmap_est) ** 2) / depthmap_true))

    return {"abs_rel": abs_rel, "sq_rel": sq_rel, "rmse": rmse,
            "rmse_log": rmse_log, "a1": a1, "a2": a2, "a3": a3}


def compute_avg_metrics(metrics_file: str) -> dict:
    """Average a space-separated metrics file (first column = filename)."""
    with open(metrics_file, "r") as f:
        keys = f.readline().split()[1:]
    metrics = np.loadtxt(metrics_file, skiprows=1,
                         usecols=range(1, len(keys) + 1), ndmin=2)
    avg = np.mean(metrics, axis=0)
    out = {k: float(v) for k, v in zip(keys, avg)}
    out["num_samples"] = metrics.shape[0]
    return out
