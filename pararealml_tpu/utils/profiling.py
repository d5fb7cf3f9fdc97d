"""Profiling utilities.

The reference's only observability is wall-clock printing (SURVEY.md §5);
this module adds on-device equivalents: XLA profiler traces viewable
in TensorBoard/Perfetto and named trace annotations that show up on the
device timeline.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Captures a device profile (compiled program timeline, HBM usage)
    for the duration of the context into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """A context manager that labels the enclosed device work with
    ``name`` on the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)


def save_device_memory_profile(path: str):
    """Dumps the current device memory profile (pprof format)."""
    jax.profiler.save_device_memory_profile(path)
