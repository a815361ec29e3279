"""Repository-wide pytest hook: build the native JPEG loaders one process at a time.

Both packages compile ``native/image_loader.cc`` with g++ on first use. The
JAX package writes every build to one shared ``_image_loader.so.tmp`` before
renaming it, so test workers started together (``pytest -n 6``) can load a
library another worker is still writing, find it unusable, and cache
``available() == False``; the native-loader tests then skip in that worker.
Here each process takes an exclusive file lock, then builds or loads both
libraries, so no process reads a half-written file.

Neither package is imported at module level: ``tests/conftest.py`` sets
``XLA_FLAGS`` before JAX is first imported.
"""

import fcntl
import os
import tempfile


def pytest_configure(config):
    lock_path = os.path.join(tempfile.gettempdir(), "multi_view_stereonet_native_build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            from multi_view_stereonet_tpu import native as jax_native
            from multi_view_stereonet_tpu_torch import native as torch_native

            jax_native.available()
            torch_native.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
