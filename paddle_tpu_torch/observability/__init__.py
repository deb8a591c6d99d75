"""Observability of the port (counterpart of ``paddle_tpu/observability``):
the flight recorder only, for now."""
from . import flight  # noqa: F401
