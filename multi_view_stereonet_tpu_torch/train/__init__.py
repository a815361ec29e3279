"""Batch unpacking and params.yaml loading; the step, the CLI and validation are
submodules (``step``, ``train_cli``, ``validation``)."""

from .config import DEFAULTS, load_params_yaml
from .pipeline import multi_view_unpack_batch, unpack_batch

__all__ = ["DEFAULTS", "load_params_yaml", "multi_view_unpack_batch", "unpack_batch"]
