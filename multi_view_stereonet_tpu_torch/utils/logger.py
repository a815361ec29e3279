"""File + stream logging setup (reference utils/logger.py:9-29): a copy of
``multi_view_stereonet_tpu/utils/logger.py``, so that the port imports nothing of the
JAX package."""

from __future__ import annotations

import logging


def create_logger(log_file: str, name: str = "multi_view_stereonet_tpu_torch",
                  level=logging.INFO):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger
