"""Serving (``serving_forward``, the single-device ``StreamingRunner``) and the eval CLI
(``test_cli.run_eval``, its metrics in ``metrics``)."""

from .streaming import StreamingRunner, load_model, serving_forward

__all__ = ["StreamingRunner", "load_model", "serving_forward"]
