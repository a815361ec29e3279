"""Config loading: a flat params.yaml compatible with the reference.

Copy of ``multi_view_stereonet_tpu/train/config.py`` (whose package import
pulls in JAX). The shipped DeMoN params.yaml lacks ``cost_volume_filter``
and ``refiners``; those keys default to the values the checkpoints were
trained with.
"""

from __future__ import annotations

import os

import yaml

DEFAULTS = {
    "size": [480, 640],
    "num_levels": 5,
    "num_idepth_samples": 12,
    "cost_volume_filter": True,
    "refiners": [True, True, True, True, True],
    "batch_size": 8,
    "batches_per_step": 1,
    "remat_refiners": False,
    "num_epochs": 150,
    "num_train_images": 0,
    "num_val_images": 0,
    "shuffle": True,
    "augment": True,
    "seed": 3,
    "optimizer": "adam",
    "learning_rate": 1e-3,
    "scheduler_gamma": 1.0,
    "estimate_right_idepthmap": False,
    "supervision_factor": 1.0,
    "reconstruction_factor": 0.0,
    "left_right_factor": 0.0,
    "num_workers": 4,
    "decode_backend": "auto",
    "print_freq": 1,
    "debug_image_freq": 50,
    "plot_freq": 500,
    "transfer_u8": False,
    "previous_checkpoint_dir": "",
    "split": "gta_sfm",
}


def load_params_yaml(path: str | None) -> dict:
    """Load a params.yaml, filling reference-compatible defaults."""
    params = dict(DEFAULTS)
    if path and os.path.exists(path):
        with open(path, "r") as f:
            params.update(yaml.safe_load(f) or {})
    return params
