"""u8 image-transport numerics: bit-exact de/quantization on the device.

Port of ``multi_view_stereonet_tpu/ops/quantize.py``. The host decode
pipeline's natural intermediate is uint8 pixels. Shipping those bytes to the
card and replicating the float conversion there cuts the host-to-device
copy 4x and removes the host's float work per image: the serving u8
transport (``eval/streaming.py`` ``--transfer_u8``).

Two replicas, because the two host pipelines differ (``data/transforms.py``):

- test/eval pipeline, ToArray + Normalize (x/255 * 2 - 1):
  ``dequantize_images_u8``;
- augmented train pipeline, ToArray alone (x/255): ``dequantize_images_u8_unit``.

Both are bit-identical to the host float path for all 256 inputs, on the
CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

# 255 * 16843009 == 2**32 - 1, so u / 255 == u * 16843009 * 2**-32 * (1 + 2**-32 + ...).
_RECIPROCAL_INT = 16843009
_ONE_OVER_255 = float(np.float32(1.0) / np.float32(255.0))


def quantize_images_u8(x: np.ndarray) -> np.ndarray:
    """Invert Normalize∘ToArray: a [-1, 1] float32 image -> the uint8 it came from.

    Exact for every value the pipeline produces: it emits only the 256 values
    fl(fl(u/255)*2-1), ~1e6 f32 ulps apart, so truncating the affine inverse
    u + 0.5 + O(ulp) recovers u. The serving transport does not call it: a
    dataset built with ``get_testing_transforms(..., u8_output=True)`` emits
    uint8 straight from the decoder; this is the inverse the tests hold the
    dequantize against."""
    tmp = x * np.float32(127.5)
    tmp += np.float32(128.0)
    return tmp.astype(np.uint8)


def _exact_unit_u8(u: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 u/255, bit-exact with numpy's float32 division.

    A literal ``u / 255.0`` is not used: a division by a scalar on the card is
    a multiply by its reciprocal, 1 ulp off the correctly rounded quotient for
    most of the 256 values. The quotient is built with exact integer ops
    instead, in int64 (PyTorch has little uint32 arithmetic): m = u * 16843009
    converted to float32 rounds at the 24-bit boundary without the positive
    (1 + 2**-32 + ...) tail, which turns exact ties to even instead of up;
    OR-ing in the low bit (m has 25 bits for u >= 1) breaks those ties upward
    and is absorbed everywhere else, except at u = 1, whose low bit is already
    set (m = 0x01010101 is an exact tie that must round up): that one value is
    patched with the host constant. The scale by 2**-32 is exact."""
    m = u.long() * _RECIPROCAL_INT
    m = m | (m != 0).long()
    v = m.float() * 2.0 ** -32
    return torch.where(u == 1, torch.full_like(v, _ONE_OVER_255), v)


def dequantize_images_u8(u: torch.Tensor) -> torch.Tensor:
    """ToArray + Normalize (``data/transforms.py``) on the tensor's device: uint8 ->
    f32/255 -> *2 - 1, bit-exact with the host pipeline. The ``*2 - 1`` stage is one
    float32 rounding on host and device alike, so exactness composes."""
    return _exact_unit_u8(u) * 2.0 - 1.0


def dequantize_images_u8_unit(u: torch.Tensor) -> torch.Tensor:
    """ToArray alone on the tensor's device: uint8 -> f32 u/255, bit-exact; the float
    conversion of the augmented train pipeline, which omits Normalize."""
    return _exact_unit_u8(u)
