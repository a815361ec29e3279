"""Batch unpacking and params.yaml loading (training itself is not ported yet)."""

from .config import DEFAULTS, load_params_yaml
from .pipeline import multi_view_unpack_batch

__all__ = ["DEFAULTS", "load_params_yaml", "multi_view_unpack_batch"]
