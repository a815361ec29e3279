"""DeMoN dataset (DPSNet-style layout).

On-disk layout (reference datasets/demon_dataset.py:18-38):
  data_dir/<scene>/0000000.jpg  (+ sibling .npy depth)
  data_dir/<scene>/cam.txt      (3x3 intrinsics)
  data_dir/<scene>/poses.txt    (rows: 3x4 world-in-camera)

Samples pair each frame with ``num_right_images`` temporal neighbors via
the reference's shift-window logic (:88-99);
T_right_in_left = T_world_in_left @ inv(T_world_in_right) (:118-120).
"""

from __future__ import annotations

import glob
import os

import numpy as np
from PIL import Image

from .native_images import (
    open_image as _open_image,
    resolve_decode_backend as _resolve_decode_backend,
)
from .splits import read_scene_list
from ..utils import depthmap_utils


class DeMoNDataset:
    def __init__(self, data_dir, input_file, num_right_images=1,
                 num_left_images=0, transform=None, shuffle=True, seed=0,
                 decode_backend="pil", load_groundtruth_depthmaps=True):
        """``load_groundtruth_depthmaps``: skip the per-sample GT .npy
        loads (1 + V full-res arrays) for serving paths that discard
        them -- mirrors GTASfMMultiViewDataset's flag."""
        self.data_dir = data_dir
        self.num_right_images = num_right_images
        self.transform = transform
        self.decode_backend = _resolve_decode_backend(decode_backend)
        self.load_groundtruth_depthmaps = load_groundtruth_depthmaps

        scenes = read_scene_list(os.path.join(data_dir, input_file)
                                 if not os.path.isabs(input_file) and
                                 os.path.exists(os.path.join(data_dir, input_file))
                                 else input_file)
        scenes = sorted(os.path.join(data_dir, s) for s in scenes)
        self.samples = self._generate(scenes, num_right_images)

        if shuffle:
            perm = np.random.default_rng(seed).permutation(len(self.samples))
            self.samples = [self.samples[i] for i in perm]
        if num_left_images > 0:
            self.samples = self.samples[:num_left_images]

        self.left_filename_to_idx = {
            s["left_filename"]: i for i, s in enumerate(self.samples)}

    @staticmethod
    def _shifts(left_idx, n_images, num_right):
        """Temporal neighbor window (reference :88-99)."""
        demi = (num_right + 1) // 2
        if left_idx < demi:
            shifts = list(range(0, num_right + 1))
            shifts.pop(left_idx)
        elif left_idx >= n_images - demi:
            shifts = list(range(n_images - (num_right + 1), n_images))
            shifts.pop(left_idx - n_images)
        else:
            shifts = list(range(left_idx - demi,
                                left_idx + (num_right + 1 + 1) // 2))
            shifts.pop(demi)
        return shifts

    def _generate(self, scenes, num_right):
        samples = []
        for scene in scenes:
            cam = os.path.join(scene, "cam.txt")
            poses_file = os.path.join(scene, "poses.txt")
            if not (os.path.exists(cam) and os.path.exists(poses_file)):
                continue
            K3 = np.genfromtxt(cam).astype(np.float32).reshape(3, 3)
            K = np.eye(4, dtype=np.float32)
            K[:3, :3] = K3
            inv_poses = np.genfromtxt(poses_file).astype(np.float32)
            if inv_poses.ndim == 1:
                inv_poses = inv_poses[None]
            images = sorted(glob.glob(os.path.join(scene, "*.jpg")))
            if len(images) < num_right + 1:
                continue

            bottom = np.array([[0, 0, 0, 1]], dtype=np.float32)
            for li in range(len(images)):
                T_w_in_l = np.concatenate(
                    [inv_poses[li].reshape(3, 4), bottom], axis=0)
                entry = {
                    "K": K,
                    "left_filename": images[li],
                    "right_filenames": [],
                    "T_right_in_left": [],
                }
                for ri in self._shifts(li, len(images), num_right):
                    T_w_in_r = np.concatenate(
                        [inv_poses[ri].reshape(3, 4), bottom], axis=0)
                    entry["right_filenames"].append(images[ri])
                    entry["T_right_in_left"].append(
                        (T_w_in_l @ np.linalg.inv(T_w_in_r)).astype(np.float32))
                samples.append(entry)
        return samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        raw = self.samples[idx]
        depth_path = os.path.splitext(raw["left_filename"])[0] + ".npy"
        sample = {
            "left_filename": raw["left_filename"],
            "right_filenames": list(raw["right_filenames"]),
            "left_image": _open_image(raw["left_filename"],
                                      self.decode_backend),
            "right_images": [_open_image(f, self.decode_backend)
                             for f in raw["right_filenames"]],
            "K": raw["K"].copy(),
            "T_right_in_left": [T.copy() for T in raw["T_right_in_left"]],
        }
        if self.load_groundtruth_depthmaps:
            sample["left_depthmap_true"] = np.load(
                depth_path).astype(np.float32)
            sample["right_depthmaps_true"] = [
                np.load(os.path.splitext(f)[0] + ".npy").astype(np.float32)
                for f in raw["right_filenames"]
            ]
        if self.transform:
            sample = self.transform(sample)
        return sample


class DeMoNStereoDataset:
    """Two-view wrapper (reference :163-197)."""

    def __init__(self, data_dir, input_file, num_left_images=0, transform=None,
                 shuffle=True, seed=0, decode_backend="pil"):
        self.inner = DeMoNDataset(data_dir, input_file, num_right_images=1,
                                  num_left_images=num_left_images,
                                  transform=transform, shuffle=shuffle,
                                  seed=seed, decode_backend=decode_backend)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx):
        return self.inner[idx]

    def get_groundtruth_disparity(self, image_file):
        idx = self.inner.left_filename_to_idx[image_file]
        s = self.inner[idx]
        return depthmap_utils.depthmap_to_disparity(
            np.asarray(s["K"])[:3, :3], np.asarray(s["T_right_in_left"][0]),
            np.asarray(s["left_depthmap_true"]))
