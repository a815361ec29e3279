"""Sample transforms: resize + intrinsics rescale, jitter, normalization,
test-time pose perturbations.

Counterpart of the reference transform pipelines
(datasets/multi_view_stereo_dataset.py:56-227). Samples are dicts:
  left_image: PIL.Image or (H, W, 3) float32
  right_images: list of same
  K: (4, 4) float32
  T_right_in_left: (V, 4, 4) float32
  left_depthmap_true / right_depthmaps_true: optional numpy arrays

Color jitter uses PIL ImageEnhance, matching torchvision's PIL backend:
random factors in the given ranges applied in a random order, with the
same jitter applied to all views of a sample (:210-227).

Reference quirk reproduced on purpose: the *augmented* training pipeline
omits the [-1, 1] normalization (:60-62); ``get_training_transforms``
keeps that behavior unless ``fix_normalization`` is set.
"""

from __future__ import annotations

import threading

import numpy as np
from PIL import Image, ImageEnhance


class ThreadLocalRng:
    """numpy-Generator proxy with an independent stream per thread.

    The randomized transforms draw from one Generator; under a
    multi-threaded ``BatchLoader`` that would be a data race AND would
    scramble the sample<->draw pairing. This proxy gives the first
    claiming thread the base generator itself and every further thread a
    child stream spawned deterministically from the base seed -- the
    same semantics as the reference's torch DataLoader, where each of
    the ``num_workers`` processes held its own RNG fork (multi-worker
    augmentation pairing is scheduling-dependent there too,
    params.yaml:19).

    Determinism contract: draws are a pure function of (base seed,
    which thread-in-claim-order draws, draw index within that thread).
    Direct in-thread iteration reproduces the raw-Generator stream
    exactly. A prefetching ``BatchLoader`` runs each epoch's transforms
    on a FRESH thread, so epoch k>=2 draws from spawn-child k-1 instead
    of continuing epoch 1's stream -- still bit-reproducible run-to-run
    at ``workers=1`` (claim order is sequential; pinned by
    tests/test_data.py::test_thread_local_rng_streams_and_augmented_workers),
    but not equal to a prefetch=0 run of the same seed. With
    ``workers>1`` the sample<->draw pairing is scheduling-dependent.

    Access-pattern caveat: stream assignment is first-draw-wins, so the
    contract is per (seed, CLAIM ORDER) -- not per seed alone. Any
    incidental draw before training (e.g. peeking ``ds[0]`` on the main
    thread) claims a stream slot and shifts every later thread's
    assignment by one. ``workers=1`` bit-reproducibility therefore
    requires an identical access pattern between the runs being
    compared, not just an identical seed. (Reserving the base stream
    would not remove this: a pre-training peek would claim spawn-child
    0 instead of the base and shift later epochs identically.)

    Built once per pipeline (``get_training_transforms`` /
    ``get_testing_transforms``) and shared by all its transforms, so two
    transforms never race on the same underlying generator from
    different threads.
    """

    def __init__(self, rng=None):
        self._base = rng if rng is not None else np.random.default_rng()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._owner_claimed = False

    def _rng(self):
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._lock:
                if not self._owner_claimed:
                    self._owner_claimed = True
                    rng = self._base
                else:
                    # Drawing from a Generator never touches its
                    # SeedSequence, so spawning here (under the lock)
                    # is safe against the owner thread's draws.
                    rng = np.random.default_rng(
                        self._base.bit_generator.seed_seq.spawn(1)[0])
            self._tls.rng = rng
        return rng

    def __getattr__(self, name):
        return getattr(self._rng(), name)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class ResizeWithIntrinsics:
    """Resize all views to (rows, cols); scale K rows 0/1 accordingly.

    Reference: ResizeImageStereo (:175-208). Ground truth is NOT resized.
    """

    def __init__(self, rows: int, cols: int):
        self.rows = rows
        self.cols = cols

    def __call__(self, sample):
        from .native_images import NativeImageRef, materialize_pil

        left = sample["left_image"]
        if isinstance(left, NativeImageRef) and left.target is not None:
            # A second resize in one pipeline: the PIL path resamples
            # twice from the intermediate size -- materialize so pixels
            # and the K rescale below match it exactly.
            sample = materialize_pil(sample)
            left = sample["left_image"]
        in_cols, in_rows = left.size
        if isinstance(left, NativeImageRef):
            # Defer the pixel work to the native decode in ToArray; the
            # intrinsics rescale below is all that happens here.
            left.target = (self.rows, self.cols)
            for r in sample["right_images"]:
                r.target = (self.rows, self.cols)
        else:
            sample["left_image"] = left.resize((self.cols, self.rows),
                                               Image.BILINEAR)
            sample["right_images"] = [
                im.resize((self.cols, self.rows), Image.BILINEAR)
                for im in sample["right_images"]
            ]
        K = np.array(sample["K"], copy=True)
        K[0, :] *= float(self.cols) / in_cols
        K[1, :] *= float(self.rows) / in_rows
        sample["K"] = K
        return sample


class RandomColorJitter:
    """Same random photometric jitter applied to every view."""

    def __init__(self, rng=None, brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
        self.rng = rng or np.random.default_rng()
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _draw(self):
        b = self.rng.uniform(*self.brightness)
        c = self.rng.uniform(*self.contrast)
        s = self.rng.uniform(*self.saturation)
        h = self.rng.uniform(*self.hue)
        order = self.rng.permutation(4)
        return b, c, s, h, order

    def _draw_spec(self):
        """One jitter draw as the spec dict both backends consume
        (native: mvs_load_images_jitter; PIL: apply_jitter_pil -- a
        single rendition, so the two cannot drift)."""
        b, c, s, h, order = self._draw()
        return {"order": [int(o) for o in order], "brightness": float(b),
                "contrast": float(c), "saturation": float(s),
                "hue_shift": int(h * 255)}

    def _jitter_fn(self, spec=None):
        from .native_images import apply_jitter_pil

        spec = spec if spec is not None else self._draw_spec()
        return lambda img: apply_jitter_pil(img, spec)

    def __call__(self, sample):
        from .native_images import has_refs, materialize_pil, sample_images

        spec = self._draw_spec()
        if has_refs(sample):
            # Native decode path: record the jitter on the refs so the
            # C++ pipeline applies it between resize and conversion
            # (bit-exact with the PIL ops; tests/test_native_loader.py).
            # Same RNG draw either way, so the two backends produce
            # identical pixels for identical seeds.
            from .. import native

            if native.available():
                for im in sample_images(sample):
                    im.jitter = spec
                return sample
        sample = materialize_pil(sample)
        fn = self._jitter_fn(spec)
        sample["left_image"] = fn(sample["left_image"])
        sample["right_images"] = [fn(im) for im in sample["right_images"]]
        return sample


class ToArray:
    """PIL -> float32 [0, 1] numpy (torchvision to_tensor equivalent).

    NativeImageRefs decode here: one thread-pooled C++ call covering
    every view of the sample (decode + pending resize + conversion)."""

    def __call__(self, sample):
        from .native_images import decode_refs, has_refs

        if has_refs(sample):
            arrs = decode_refs([sample["left_image"]]
                               + list(sample["right_images"]))
            sample["left_image"] = arrs[0]
            sample["right_images"] = arrs[1:]
            return sample
        sample["left_image"] = np.asarray(
            sample["left_image"], dtype=np.float32) / 255.0
        sample["right_images"] = [
            np.asarray(im, dtype=np.float32) / 255.0
            for im in sample["right_images"]
        ]
        return sample


class ToArrayU8:
    """PIL -> raw uint8 HWC numpy; terminal step of the u8-transport
    serving pipeline (replaces ToArray+Normalize; the device replicates
    both bit-exactly, eval/streaming.dequantize_images_u8). 4x fewer
    host->device bytes and zero host-side float work per image."""

    def __call__(self, sample):
        from .native_images import decode_refs, has_refs

        if has_refs(sample):
            arrs = decode_refs([sample["left_image"]]
                               + list(sample["right_images"]), u8=True)
            sample["left_image"] = arrs[0]
            sample["right_images"] = arrs[1:]
            return sample
        sample["left_image"] = np.asarray(sample["left_image"], dtype=np.uint8)
        sample["right_images"] = [
            np.asarray(im, dtype=np.uint8) for im in sample["right_images"]
        ]
        return sample


class Normalize:
    """Map [0, 1] images to [-1, 1] (mean=std=0.5, :100-106)."""

    def __call__(self, sample):
        sample["left_image"] = sample["left_image"] * 2.0 - 1.0
        sample["right_images"] = [im * 2.0 - 1.0 for im in sample["right_images"]]
        return sample


class RollRight180:
    """Rotate right views 180 deg and adjust poses (:126-146)."""

    def __call__(self, sample):
        from .native_images import materialize_pil

        sample = materialize_pil(sample)
        T_roll = np.eye(4, dtype=np.float32)
        T_roll[0, 0] = -1.0
        T_roll[1, 1] = -1.0
        rights = []
        for i, im in enumerate(sample["right_images"]):
            arr = np.asarray(im)
            rights.append(Image.fromarray(np.ascontiguousarray(arr[::-1, ::-1])))
            sample["T_right_in_left"][i] = sample["T_right_in_left"][i] @ T_roll
            if "right_depthmaps_true" in sample:
                d = sample["right_depthmaps_true"][i]
                sample["right_depthmaps_true"][i] = np.ascontiguousarray(d[::-1, ::-1])
        sample["right_images"] = rights
        return sample


class RandomHorizontalFlipStereo:
    """Horizontal flip of a two-view pair with pose reflection.

    Reflection across the YZ plane at the left camera: images flip left /
    right swap, the pose becomes reflect(inv(T)) with the x-axis re-derived
    as y cross z to restore a right-handed frame. Reference:
    datasets/stereo_dataset.py:179-212 (defined there, disabled in the
    shipped train transforms :69 -- carried for capability parity).
    Applies only to samples with exactly one right view.
    """

    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = rng or np.random.default_rng()
        self.reflection = np.eye(4, dtype=np.float32)
        self.reflection[0, 0] = -1.0

    @staticmethod
    def _flip(im):
        if isinstance(im, Image.Image):
            return im.transpose(Image.FLIP_LEFT_RIGHT)
        return np.ascontiguousarray(np.asarray(im)[:, ::-1])

    def __call__(self, sample):
        if len(sample["right_images"]) != 1 or self.rng.uniform() >= self.prob:
            return sample
        from .native_images import materialize_pil

        sample = materialize_pil(sample)
        left, right = sample["left_image"], sample["right_images"][0]
        sample["left_image"] = self._flip(right)
        sample["right_images"] = [self._flip(left)]

        T = np.asarray(sample["T_right_in_left"][0])
        T = self.reflection @ np.linalg.inv(T)
        T[:3, 0] = np.cross(T[:3, 1], T[:3, 2])
        sample["T_right_in_left"][0] = T.astype(np.float32)

        if "left_depthmap_true" in sample:
            ld = sample["left_depthmap_true"]
            rd = sample["right_depthmaps_true"][0]
            sample["left_depthmap_true"] = self._flip(rd)
            sample["right_depthmaps_true"] = [self._flip(ld)]
        return sample


class TranslationNoise:
    """Gaussian translation noise on poses (:148-155)."""

    def __init__(self, sigma=1.0, rng=None):
        self.sigma = sigma
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        for i in range(len(sample["T_right_in_left"])):
            sample["T_right_in_left"][i][:3, 3] += self.rng.normal(
                0.0, self.sigma, size=3).astype(np.float32)
        return sample


class RotationNoise:
    """Gaussian axis-angle rotation noise on poses (:157-173)."""

    def __init__(self, sigma_deg=1.0, rng=None):
        self.sigma_deg = sigma_deg
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        for i in range(len(sample["T_right_in_left"])):
            aa = self.rng.normal(0.0, self.sigma_deg, size=3)
            angle = np.linalg.norm(aa)
            axis = aa / angle
            a = np.deg2rad(angle)
            Kx = np.array([[0, -axis[2], axis[1]],
                           [axis[2], 0, -axis[0]],
                           [-axis[1], axis[0], 0]])
            R = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * (Kx @ Kx)
            T = sample["T_right_in_left"][i]
            T[:3, :3] = (R @ T[:3, :3]).astype(np.float32)
        return sample


def get_training_transforms(params: dict, rng=None, fix_normalization=False,
                            u8_output=False):
    """Train pipeline (reference :56-68). With augment=True the reference
    omits Normalize -- reproduced unless ``fix_normalization``.

    ``u8_output`` ends the pipeline at raw uint8 pixels (the jitter
    chain's natural domain) instead of float32 -- the training
    u8-transport mode (train_cli ``transfer_u8``): 4x fewer image bytes
    host->device, with the omitted float stage(s) replicated bit-exactly
    inside the jitted train step (ops/quantize: the bare x/255 when this
    pipeline omits Normalize, x/255*2-1 otherwise --
    ``training_u8_dequantize_mode`` returns which)."""
    rows, cols = params["size"]
    rng = ThreadLocalRng(rng)
    if params.get("augment", False):
        steps = [ResizeWithIntrinsics(rows, cols), RandomColorJitter(rng)]
        if u8_output:
            return Compose(steps + [ToArrayU8()])
        steps.append(ToArray())
        if fix_normalization:
            steps.append(Normalize())
        return Compose(steps)
    if u8_output:
        return Compose([ResizeWithIntrinsics(rows, cols), ToArrayU8()])
    return Compose([ResizeWithIntrinsics(rows, cols), ToArray(), Normalize()])


def training_u8_dequantize_mode(params: dict, fix_normalization=False) -> str:
    """Which device-side dequantize replicates the float stage(s) the
    u8 training pipeline omitted: "unit" (bare x/255 -- the augmented
    recipe, which skips Normalize) or "full" (x/255*2-1)."""
    if params.get("augment", False) and not fix_normalization:
        return "unit"
    return "full"


def get_testing_transforms(params: dict, roll_right_image180=False,
                           add_trans_noise=False, add_rot_noise=False,
                           rng=None, u8_output=False):
    """Test pipeline with optional robustness perturbations (:70-98).

    ``u8_output`` ends the pipeline at raw uint8 pixels instead of
    normalized float32 -- the serving u8-transport mode
    (eval/streaming --transfer_u8), which normalizes on-device."""
    rows, cols = params["size"]
    rng = ThreadLocalRng(rng)
    steps = []
    if roll_right_image180:
        steps.append(RollRight180())
    elif add_trans_noise:
        steps.append(TranslationNoise(rng=rng))
    elif add_rot_noise:
        steps.append(RotationNoise(rng=rng))
    steps.append(ResizeWithIntrinsics(rows, cols))
    steps += [ToArrayU8()] if u8_output else [ToArray(), Normalize()]
    return Compose(steps)
