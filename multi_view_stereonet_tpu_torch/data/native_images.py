"""Lazy image references backed by the native (C++) decode pipeline.

Datasets built with ``decode_backend="native"`` put ``NativeImageRef``
objects in the sample instead of PIL images; the standard transform
pipeline then runs decode + Pillow-parity bilinear resize + [0,1]
conversion inside native.image_loader (one thread-pooled call for all
views of a sample), which measures ~1.4x faster than PIL per core and
scales across cores. Pixel-exact: the native resample replicates
Pillow's BILINEAR filter bit-for-bit (see native/image_loader.cc).

Image-mutating augmentations (color jitter, roll180, flips) call
``materialize_pil`` first, which transparently converts refs back to
real PIL images (decode + resize through PIL), so every pipeline works
with either backend.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


class NativeImageRef:
    """A to-be-decoded image path with an optional pending resize."""

    def __init__(self, path: str):
        self.path = path
        self.target = None  # (rows, cols) set by ResizeWithIntrinsics
        self.jitter = None  # dict set by RandomColorJitter (native path)
        self._size = None

    @property
    def size(self):
        """(width, height), PIL convention; header-only read."""
        if self._size is None:
            from .. import native

            dims = native.jpeg_dims(self.path)
            if dims is None:
                dims = Image.open(self.path).size
            self._size = dims
        return self._size

    def to_pil(self) -> Image.Image:
        """Materialize through PIL (decode + pending resize + jitter)."""
        img = Image.open(self.path).convert("RGB")
        if self.target is not None:
            rows, cols = self.target
            img = img.resize((cols, rows), Image.BILINEAR)
        if self.jitter is not None:
            img = apply_jitter_pil(img, self.jitter)
        return img


def sample_images(sample):
    """The sample's image entries as one flat list [left, *rights]."""
    return [sample["left_image"]] + list(sample["right_images"])


def has_refs(sample) -> bool:
    return isinstance(sample["left_image"], NativeImageRef)


def materialize_pil(sample):
    """Convert any NativeImageRefs in the sample back to PIL images."""
    if not has_refs(sample):
        return sample
    sample["left_image"] = sample["left_image"].to_pil()
    sample["right_images"] = [r.to_pil() for r in sample["right_images"]]
    return sample


def apply_jitter_pil(img: Image.Image, spec: dict) -> Image.Image:
    """The PIL rendition of a recorded jitter spec (fallback path;
    bit-exact twin of the native ApplyJitter)."""
    from PIL import ImageEnhance

    for op in spec["order"]:
        if op == 0:
            img = ImageEnhance.Brightness(img).enhance(spec["brightness"])
        elif op == 1:
            img = ImageEnhance.Contrast(img).enhance(spec["contrast"])
        elif op == 2:
            img = ImageEnhance.Color(img).enhance(spec["saturation"])
        else:
            hsv = np.array(img.convert("HSV"))
            hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                           + spec["hue_shift"]) % 256
            img = Image.fromarray(hsv, "HSV").convert("RGB")
    return img


def decode_refs(refs, u8=False):
    """Decode a list of refs -> float32 [0, 1] HWC arrays (or raw uint8
    pixels with ``u8=True`` -- the serving u8-transport path, which
    normalizes on-device instead).

    One native call per (target size, jitter spec) group -- all views of
    a training sample share one spec, so this stays one pooled call per
    sample; failed decodes fall back to PIL per image (jitter included).
    """
    from .. import native

    out = [None] * len(refs)
    groups = {}
    for i, r in enumerate(refs):
        if r.target is not None:
            rows, cols = r.target
        else:
            w, h = r.size
            rows, cols = h, w
        groups.setdefault((rows, cols, id(r.jitter)), []).append(i)

    fallback_dtype = np.uint8 if u8 else np.float32
    for (rows, cols, _), idxs in groups.items():
        spec = refs[idxs[0]].jitter
        paths = [refs[i].path for i in idxs]
        if spec is None:
            if u8:
                arrs, ok = native.load_images_u8(paths, rows, cols)
            else:
                arrs, ok = native.load_images(paths, rows, cols)
        elif u8:
            # Training u8 transport: the jitter chain is u8 end-to-end,
            # so the native loader emits its natural intermediate and
            # the device applies the bit-exact x/255
            # (ops/quantize.dequantize_images_u8_unit).
            arrs, ok = native.load_images_jitter_u8(
                paths, rows, cols, spec["order"], spec["brightness"],
                spec["contrast"], spec["saturation"], spec["hue_shift"])
        else:
            arrs, ok = native.load_images_jitter(
                paths, rows, cols, spec["order"], spec["brightness"],
                spec["contrast"], spec["saturation"], spec["hue_shift"])
        for j, i in enumerate(idxs):
            if ok[j]:
                out[i] = arrs[j]
            else:
                arr = np.asarray(refs[i].to_pil(), dtype=fallback_dtype)
                out[i] = arr if u8 else arr / 255.0
    return out


def resolve_decode_backend(backend: str) -> str:
    """'auto' -> 'native' when the C++ loader is usable, else 'pil'.

    An explicit 'native' fails fast here (at dataset construction)
    rather than deep inside a loader thread on the first decode."""
    if backend == "auto":
        from .. import native

        return "native" if native.available() else "pil"
    if backend == "native":
        from .. import native

        if not native.available():
            raise RuntimeError(
                "decode_backend='native' requested but the native image "
                "loader is unavailable (toolchain/libjpeg missing or the "
                "Pillow parity probe failed); use 'auto' or 'pil'")
        return backend
    if backend != "pil":
        raise ValueError(f"unknown decode_backend {backend!r}")
    return backend


def open_image(path: str, backend: str = "pil"):
    """PIL image or NativeImageRef, per backend."""
    if backend == "native":
        return NativeImageRef(path)
    return Image.open(path).convert("RGB")
