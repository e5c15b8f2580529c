"""Utilities: tracing and timing, the viewer socket and logging
(counterpart of f3d_gaus_tpu/utils/)."""
from . import profiling, logging  # noqa: F401
