"""Native (C++) runtime components, bound through ctypes.

``image_loader.cc`` is compiled on demand with the system toolchain into
``_build/_image_loader.so`` under the package directory (git-ignored;
rebuilt when the source is newer), never beside the source. Everything
degrades gracefully: ``available()`` is False when the toolchain or
libjpeg is missing, or when MVSNET_TPU_NO_NATIVE is set, and callers
fall back to the PIL path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "image_loader.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD_DIR, "_image_loader.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # -ffp-contract=off: the jitter's Pillow bit-parity depends on the
    # literal two-rounding float blend (an fma contraction would merge
    # them); everything else is integer/fixed-point and unaffected.
    tmp = f"{_LIB}.{os.getpid()}.tmp"  # parallel test workers may build at once
    base = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC", _SRC,
            "-o", tmp, "-ljpeg", "-lpthread"]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # The library is always built on the machine that runs it, so
    # -march=native is safe; retry portable if the flag is rejected.
    for cmd in ([base[0], "-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            break
        except (OSError, subprocess.SubprocessError):
            continue
    else:
        return False
    os.replace(tmp, _LIB)
    return True


def _load():
    """Build (if stale) and dlopen the library; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MVSNET_TPU_NO_NATIVE"):
            return None
        try:
            stale = (not os.path.exists(_LIB)
                     or os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
            if stale and not _build():
                return None
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.mvs_native_version.restype = ctypes.c_int
        if lib.mvs_native_version() != 4:
            # Stale binary from an older source (mtime check can miss
            # e.g. a git checkout restoring an old timestamp): rebuild.
            try:
                if not _build():
                    return None
                lib = ctypes.CDLL(_LIB)
            except OSError:
                return None
            if lib.mvs_native_version() != 4:
                return None
        lib.mvs_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.mvs_jpeg_dims.restype = ctypes.c_int
        lib.mvs_load_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.mvs_load_images.restype = None
        lib.mvs_load_images_jitter.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.mvs_load_images_jitter.restype = None
        lib.mvs_load_images_jitter_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.mvs_load_images_jitter_u8.restype = None
        lib.mvs_load_images_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.mvs_load_images_u8.restype = None
        if not _parity_check(lib):
            return None
        _lib = lib
        return _lib


def _parity_check(lib) -> bool:
    """One-time decode+resize parity probe against Pillow.

    'available' promises BIT-EXACT agreement with the PIL pipeline
    (eval defaults to the native path) -- that holds only when the
    system libjpeg produces the same pixels as Pillow's bundled
    libjpeg-turbo. Probe with a real JPEG round trip instead of
    trusting the link; mismatching hosts silently keep PIL.
    """
    import tempfile

    import numpy as np
    from PIL import Image

    try:
        rng = np.random.default_rng(0)
        arr = rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
        with tempfile.NamedTemporaryFile(suffix=".jpg", delete=False) as f:
            path = f.name
        Image.fromarray(arr, "RGB").save(path, quality=92)
        try:
            for rows, cols in ((40, 56), (24, 32)):
                out = np.empty((1, rows, cols, 3), np.float32)
                status = np.empty((1,), np.int32)
                ap = (ctypes.c_char_p * 1)(path.encode())
                lib.mvs_load_images(
                    ap, 1, rows, cols, ctypes.c_float(0.0),
                    ctypes.c_float(1.0),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1)
                if status[0] != 0:
                    return False
                pil = Image.open(path).convert("RGB")
                if pil.size != (cols, rows):
                    pil = pil.resize((cols, rows), Image.BILINEAR)
                ref = np.asarray(pil, np.float32) / 255.0
                if not np.array_equal(out[0], ref):
                    return False
                u8 = np.empty((1, rows, cols, 3), np.uint8)
                lib.mvs_load_images_u8(
                    ap, 1, rows, cols,
                    u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1)
                if status[0] != 0 or not np.array_equal(
                        u8[0], np.asarray(pil, np.uint8)):
                    return False
            # Jitter path: ``available`` also gates the C++ training
            # augmentation (decode_backend=auto is the train default),
            # so probe all 4 ops too. Factors chosen float-exactness-
            # hostile (non-representable, alpha > 1); a compiler that
            # contracts the blend's two roundings into an fma, x87
            # excess precision, or any ApplyJitter drift fails here and
            # the host silently keeps PIL.
            from ..data.native_images import apply_jitter_pil

            spec = {"order": [1, 3, 0, 2], "brightness": 1.1999,
                    "contrast": 0.8123, "saturation": 1.2,
                    "hue_shift": -17}
            out = np.empty((1, 24, 32, 3), np.float32)
            order_arr = (ctypes.c_int * 4)(*spec["order"])
            lib.mvs_load_images_jitter(
                ap, 1, 24, 32, order_arr, 4,
                ctypes.c_float(spec["brightness"]),
                ctypes.c_float(spec["contrast"]),
                ctypes.c_float(spec["saturation"]),
                ctypes.c_int(spec["hue_shift"]),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1)
            if status[0] != 0:
                return False
            pil = Image.open(path).convert("RGB").resize(
                (32, 24), Image.BILINEAR)
            jit_ref = apply_jitter_pil(pil, spec)
            ref = np.asarray(jit_ref, np.float32) / 255.0
            if not np.array_equal(out[0], ref):
                return False
            # Jitter u8 output mode (training u8 transport): the same
            # chain minus the float convert must emit the exact bytes
            # the f32 path divides by 255.
            u8j = np.empty((1, 24, 32, 3), np.uint8)
            lib.mvs_load_images_jitter_u8(
                ap, 1, 24, 32, order_arr, 4,
                ctypes.c_float(spec["brightness"]),
                ctypes.c_float(spec["contrast"]),
                ctypes.c_float(spec["saturation"]),
                ctypes.c_int(spec["hue_shift"]),
                u8j.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1)
            if status[0] != 0 or not np.array_equal(
                    u8j[0], np.asarray(jit_ref, np.uint8)):
                return False
        finally:
            os.unlink(path)
        return True
    except Exception:
        return False


def available() -> bool:
    """True when the native image loader can be used (library builds,
    loads, and passes the Pillow bit-parity probe)."""
    return _load() is not None


def jpeg_dims(path: str):
    """(width, height) from the JPEG header, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.mvs_jpeg_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def load_images(paths, rows: int, cols: int, mean: float = 0.0,
                std: float = 1.0, threads: int = 0):
    """Decode + Pillow-parity bilinear resize + normalize, in C++.

    Returns (images (n, rows, cols, 3) float32 with (x/255 - mean)/std,
    ok (n,) bool). Failed decodes have ok False (callers fall back to
    PIL for those). ``threads`` 0 picks min(n, cpu count).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    n = len(paths)
    out = np.empty((n, rows, cols, 3), np.float32)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if threads <= 0:
        threads = min(n, os.cpu_count() or 1)
    lib.mvs_load_images(
        arr, n, rows, cols, ctypes.c_float(mean), ctypes.c_float(std),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    return out, status == 0


def load_images_u8(paths, rows: int, cols: int, threads: int = 0):
    """Decode + Pillow-parity bilinear resize, raw uint8 pixels.

    Returns (images (n, rows, cols, 3) uint8, ok (n,) bool). Same pixels
    ToArray would divide by 255 -- the serving u8-transport path ships
    these to the device and normalizes there (bit-exact,
    eval/streaming.dequantize_images_u8)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    n = len(paths)
    out = np.empty((n, rows, cols, 3), np.uint8)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if threads <= 0:
        threads = min(n, os.cpu_count() or 1)
    lib.mvs_load_images_u8(
        arr, n, rows, cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    return out, status == 0


def load_images_jitter(paths, rows: int, cols: int, order, brightness: float,
                       contrast: float, saturation: float, hue_shift: int,
                       threads: int = 0):
    """Decode + resize + Pillow-bit-exact color jitter + x/255, in C++.

    ``order``: sequence of op codes (0 brightness, 1 contrast,
    2 saturation, 3 hue) applied in order with ONE parameter set for the
    whole call (all views of a sample share the jitter draw, matching
    the reference RandomColorJitterStereo). Returns (images, ok) like
    ``load_images``; failed decodes fall back to PIL caller-side.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    n = len(paths)
    out = np.empty((n, rows, cols, 3), np.float32)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    order_arr = (ctypes.c_int * len(order))(*[int(o) for o in order])
    if threads <= 0:
        threads = min(n, os.cpu_count() or 1)
    lib.mvs_load_images_jitter(
        arr, n, rows, cols, order_arr, len(order),
        ctypes.c_float(brightness), ctypes.c_float(contrast),
        ctypes.c_float(saturation), ctypes.c_int(int(hue_shift)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    return out, status == 0


def load_images_jitter_u8(paths, rows: int, cols: int, order,
                          brightness: float, contrast: float,
                          saturation: float, hue_shift: int,
                          threads: int = 0):
    """Decode + resize + Pillow-bit-exact color jitter, RAW uint8 pixels.

    Same chain as ``load_images_jitter`` minus the final x/255 -- the
    training u8-transport path (train_cli ``transfer_u8``) ships these
    bytes to the device and applies the bit-exact x/255 there
    (ops/quantize.dequantize_images_u8_unit). Returns (images (n, rows,
    cols, 3) uint8, ok (n,) bool)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    n = len(paths)
    out = np.empty((n, rows, cols, 3), np.uint8)
    status = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    order_arr = (ctypes.c_int * len(order))(*[int(o) for o in order])
    if threads <= 0:
        threads = min(n, os.cpu_count() or 1)
    lib.mvs_load_images_jitter_u8(
        arr, n, rows, cols, order_arr, len(order),
        ctypes.c_float(brightness), ctypes.c_float(contrast),
        ctypes.c_float(saturation), ctypes.c_int(int(hue_shift)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads)
    return out, status == 0
