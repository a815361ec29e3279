"""PFM (portable float map) IO -- SceneFlow ground-truth format.

A numpy-only copy of ``multi_view_stereonet_tpu/utils/pfm_utils.py`` (reference
utils/pfm_utils.py:6-70), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str):
    """Returns (data, scale). Data is flipped to row-major top-down."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = np.reshape(data, shape)
        return np.flipud(data), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("Image must be HxWx3, HxW, or HxWx1.")

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)
