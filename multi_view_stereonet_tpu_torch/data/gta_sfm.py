"""GTA-SfM dataset: per-sequence intrinsics/poses text files + npy depth.

On-disk layout (reference datasets/gta_sfm_dataset.py:161-180 and
scripts/gta_sfm/extract.py):

  data_dir/<seq>/color/NNNNNN.jpg
  data_dir/<seq>/depth/NNNNNN.npy
  data_dir/<seq>/intrinsics.txt   (header + rows: id k00 k01 ... k22)
  data_dir/<seq>/poses.txt        (header + rows: id t00 ... t33)

Quirk reproduced: the dataset's principal points are off by +0.5 pixel;
both cx and cy are corrected by -0.5 on load
(gta_sfm_dataset.py:294-303,400-411).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .native_images import (
    open_image as _open_image,
    resolve_decode_backend as _resolve_decode_backend,
)
from .splits import read_multi_view_split
from ..utils import depthmap_utils


def _load_table(path):
    data = np.loadtxt(path, skiprows=1, dtype=np.float32, ndmin=2)
    return data[:, 0].astype(np.int64), data[:, 1:]


class _SequenceCache:
    """Caches per-sequence intrinsics/poses tables."""

    def __init__(self, data_dir):
        self.data_dir = data_dir
        self._cache = {}

    def lookup(self, rel_image_path):
        tokens = rel_image_path.split(os.path.sep)
        seq_dir = os.path.join(self.data_dir, *tokens[:-2])
        image_id = int(os.path.splitext(tokens[-1])[0])
        if seq_dir not in self._cache:
            k_ids, ks = _load_table(os.path.join(seq_dir, "intrinsics.txt"))
            p_ids, ps = _load_table(os.path.join(seq_dir, "poses.txt"))
            self._cache[seq_dir] = (
                dict(zip(k_ids.tolist(), ks)), dict(zip(p_ids.tolist(), ps)))
        kmap, pmap = self._cache[seq_dir]
        K3 = kmap[image_id].reshape(3, 3).copy()
        K3[0, 2] -= 0.5  # principal-point fix (reference :400-411)
        K3[1, 2] -= 0.5
        pose = pmap[image_id].reshape(4, 4)
        return K3, pose


class GTASfMMultiViewDataset:
    """Multi-view samples from a split file.

    Reference: GTASfMMultiViewStereoDataset (gta_sfm_dataset.py:341-434).
    Shuffling is *seeded* here (the reference shuffles unseeded on
    construction, multi_view_stereo_dataset.py:259-269).
    """

    def __init__(self, data_dir, split_file, num_images=0, transform=None,
                 load_groundtruth_depthmaps=False, shuffle=True, seed=0,
                 decode_backend="pil"):
        self.data_dir = data_dir
        self.transform = transform
        self.load_gt = load_groundtruth_depthmaps
        self.decode_backend = _resolve_decode_backend(decode_backend)

        lefts, rights = read_multi_view_split(split_file)
        if shuffle:
            perm = np.random.default_rng(seed).permutation(len(lefts))
            lefts = [lefts[i] for i in perm]
            rights = [rights[i] for i in perm]
        if num_images > 0:
            lefts, rights = lefts[:num_images], rights[:num_images]
        self.left_names = lefts
        self.right_names = rights
        self._seqs = _SequenceCache(data_dir)

    def __len__(self):
        return len(self.left_names)

    @staticmethod
    def depth_path(image_path):
        # splitext, not str.replace: a substring replace would corrupt
        # stems containing "jpg" and silently no-op on .png splits
        # (create_mvs_split parameterizes the image extension).
        tokens = image_path.split(os.path.sep)
        tokens[-2] = "depth"
        tokens[-1] = os.path.splitext(tokens[-1])[0] + ".npy"
        return os.path.sep.join(tokens)

    def __getitem__(self, idx):
        left_rel = self.left_names[idx]
        right_rels = self.right_names[idx]
        left_path = os.path.join(self.data_dir, left_rel)

        K3, left_pose = self._seqs.lookup(left_rel)
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = K3

        T_rights = []
        for r in right_rels:
            _, right_pose = self._seqs.lookup(r)
            T_rights.append(
                (np.linalg.inv(left_pose) @ right_pose).astype(np.float32))

        right_paths = [os.path.join(self.data_dir, r) for r in right_rels]
        sample = {
            "left_filename": left_path,
            "right_filenames": right_paths,
            "left_image": _open_image(left_path, self.decode_backend),
            "right_images": [_open_image(p, self.decode_backend)
                             for p in right_paths],
            "K": K,
            "T_right_in_left": T_rights,
        }
        if self.load_gt:
            sample["left_depthmap_true"] = np.load(self.depth_path(left_path))
            sample["right_depthmaps_true"] = [
                np.load(self.depth_path(os.path.join(self.data_dir, r)))
                for r in right_rels
            ]
        if self.transform:
            sample = self.transform(sample)
        return sample


class GTASfMStereoDataset(GTASfMMultiViewDataset):
    """Two-view variant with optional GT disparity.

    Reference: GTASfMStereoDataset (gta_sfm_dataset.py:235-339).
    """

    def __init__(self, *args, load_groundtruth_disparity=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.load_gt_disparity = load_groundtruth_disparity

    def __getitem__(self, idx):
        sample = super().__getitem__(idx)
        if self.load_gt_disparity:
            K3, _ = self._seqs.lookup(self.left_names[idx])
            T = sample["T_right_in_left"][0]
            depth = sample.get("left_depthmap_true")
            if depth is None:
                depth = np.load(self.depth_path(sample["left_filename"]))
            sample["left_disparity_true"] = depthmap_utils.depthmap_to_disparity(
                K3, T, depth)
        return sample


def _depth_overlap(ref_K4, ref_depth, cmp_K4, cmp_depth, T_cmp_in_ref):
    """Fraction of ref pixels whose projection lands with valid depth."""
    pts = depthmap_utils.depthmap_to_point_cloud(ref_K4[:3, :3], ref_depth)
    proj = depthmap_utils.point_cloud_to_depthmap(
        cmp_depth.shape, cmp_K4, T_cmp_in_ref, pts)
    return np.sum(proj > 0) / ref_depth.size


def _image_id(path):
    return int(os.path.splitext(os.path.basename(path))[0])


def create_mvs_split(data_dir, output_file, num_comparison_frames=1,
                     method="depth", min_overlap=0.5, min_trans_diff=0.1,
                     max_trans_diff=5.0, min_angle_diff_deg=0.0,
                     max_angle_diff_deg=45.0, ext="jpg", seed=0,
                     pyramid_level=4):
    """Offline split curation: pick comparison frames for each reference.

    ``method="depth"`` (reference sample_comparison_frames_with_depthmaps,
    gta_sfm_dataset.py:68-161): keep frames whose bidirectional
    projected-depth overlap exceeds ``min_overlap`` with baseline above
    ``min_trans_diff``; sample, then sort the chosen frames by baseline.

    ``method="pose"`` (reference sample_comparison_frames_with_poses,
    gta_sfm_dataset.py:17-66): keep frames within the
    [min_trans_diff, max_trans_diff] translation window AND the
    [min_angle_diff_deg, max_angle_diff_deg] viewing-direction (z-axis)
    window; sample without baseline sorting. The reference defaults that
    sampler to min_trans_diff=0.5.

    Unlike the reference (which zips the pose/intrinsics tables with the
    image list by row position and breaks on sequences with frame-id
    gaps), both tables and the depth files are keyed by image id here,
    matching the runtime _SequenceCache.
    """
    import glob

    assert method in ("depth", "pose"), method
    rng = np.random.default_rng(seed)
    assert not os.path.exists(output_file), output_file
    scale = 1 << pyramid_level

    with open(output_file, "a") as out:
        for seq in sorted(os.listdir(data_dir)):
            seq_dir = os.path.join(data_dir, seq)
            images = sorted(glob.glob(os.path.join(seq_dir, "color", f"*{ext}")))
            if not images:
                continue
            p_ids, poses = _load_table(os.path.join(seq_dir, "poses.txt"))
            k_ids, ks = _load_table(os.path.join(seq_dir, "intrinsics.txt"))
            pose_by_id = dict(zip(p_ids.tolist(), poses))
            k_by_id = dict(zip(k_ids.tolist(), ks))

            downs, K4s, Ts = [], [], []
            for img in images:
                iid = _image_id(img)
                Ts.append(pose_by_id[iid].reshape(4, 4))
                if method == "depth":
                    K = k_by_id[iid].reshape(3, 3) / scale
                    K[2, 2] = 1.0
                    K4 = np.eye(4)
                    K4[:3, :3] = K
                    K4s.append(K4)
                    stem = os.path.splitext(os.path.basename(img))[0]
                    depth_path = os.path.join(seq_dir, "depth", stem + ".npy")
                    downs.append(np.load(depth_path)[::scale, ::scale])

            for ref in range(len(images)):
                valid, baselines = [], []
                for cmp_ in range(len(images)):
                    if cmp_ == ref:
                        continue
                    T_ref_in_cmp = np.linalg.inv(Ts[cmp_]) @ Ts[ref]
                    baseline = np.linalg.norm(T_ref_in_cmp[:3, 3])
                    if method == "pose":
                        angle = np.degrees(np.abs(np.arccos(np.clip(
                            np.dot(Ts[ref][:3, 2], Ts[cmp_][:3, 2]),
                            -1.0, 1.0))))
                        if not (min_trans_diff <= baseline <= max_trans_diff):
                            continue
                        if not (min_angle_diff_deg <= angle
                                <= max_angle_diff_deg):
                            continue
                    else:
                        T_cmp_in_ref = np.linalg.inv(Ts[ref]) @ Ts[cmp_]
                        if baseline <= min_trans_diff:
                            continue
                        o1 = _depth_overlap(K4s[ref], downs[ref], K4s[cmp_],
                                            downs[cmp_], T_cmp_in_ref)
                        if o1 <= min_overlap:
                            continue
                        o2 = _depth_overlap(K4s[cmp_], downs[cmp_], K4s[ref],
                                            downs[ref], T_ref_in_cmp)
                        if o2 <= min_overlap:
                            continue
                    valid.append(cmp_)
                    baselines.append(baseline)
                if len(valid) < num_comparison_frames:
                    continue
                perm = rng.permutation(len(valid))[:num_comparison_frames]
                if method == "depth":  # the pose sampler keeps sample order
                    perm = sorted(perm, key=lambda j: baselines[j])
                out.write(os.path.relpath(images[ref], data_dir))
                for j in perm:
                    out.write(" " + os.path.relpath(images[valid[j]], data_dir))
                out.write("\n")
