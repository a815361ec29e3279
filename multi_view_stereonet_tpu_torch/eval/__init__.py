"""Serving: ``serving_forward`` and the single-device ``StreamingRunner``."""

from .streaming import StreamingRunner, load_model, serving_forward

__all__ = ["StreamingRunner", "load_model", "serving_forward"]
