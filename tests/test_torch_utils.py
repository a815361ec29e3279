"""The port's numpy-only copies of ``utils/pfm_utils.py`` and ``utils/logger.py`` against
the JAX package's: a PFM file written by either package reads back bit-equal, with its
scale, in the other (gray and color, both byte orders); the logger writes the same lines
through the same handlers."""

import logging

import numpy as np
import pytest

from multi_view_stereonet_tpu.utils import logger as jax_logger
from multi_view_stereonet_tpu.utils import pfm_utils as jax_pfm
from multi_view_stereonet_tpu_torch.utils import logger, pfm_utils

PACKAGES = {"jax": jax_pfm, "port": pfm_utils}


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (4, 6, 3)])
@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_pfm_files_cross_between_the_packages(shape, byteorder, writer, reader, tmp_path):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    image = rng.standard_normal(shape).astype(byteorder + "f4")
    image.flat[0] = np.inf
    path = str(tmp_path / "x.pfm")
    PACKAGES[writer].write_pfm(path, image, scale=2.5)
    data, scale = PACKAGES[reader].read_pfm(path)
    ref, ref_scale = PACKAGES[writer].read_pfm(path)
    assert scale == ref_scale == 2.5
    expected = image.reshape(data.shape).astype(np.float32)
    assert data.shape == ref.shape == shape[:2] + ((3,) if shape[-1] == 3 else ())
    np.testing.assert_array_equal(data, expected)
    assert data.tobytes() == ref.tobytes()


def test_logger_matches_the_jax_package(tmp_path):
    lines = {}
    for name, module in (("jax", jax_logger), ("port", logger)):
        path = tmp_path / f"{name}.log"
        log = module.create_logger(str(path), name=f"test_{name}", level=logging.DEBUG)
        assert [type(h) for h in log.handlers] == [logging.FileHandler,
                                                   logging.StreamHandler]
        log.debug("step %d", 3)
        log.warning("loss %s", "nan")
        for h in log.handlers:
            h.close()
        lines[name] = [line.split(" ", 2)[2] for line in path.read_text().splitlines()]
    assert lines["port"] == lines["jax"] == ["DEBUG step 3", "WARNING loss nan"]
