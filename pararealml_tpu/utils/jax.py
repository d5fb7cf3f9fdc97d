"""JAX runtime configuration utilities.

Capability match for /root/reference/pararealml/utils/tf.py:8-35, which
configures TensorFlow devices and determinism for the ML operators:

- ``use_cpu``: force computations onto the host CPU backend.
- ``use_double_precision``: enable float64 (the reference is implicitly
  float64 through NumPy; on accelerators float32 is the performant
  default, so this is opt-in).
- ``limit_visible_devices``: restrict the process's default device — the
  analog of the reference's per-MPI-rank GPU pinning
  (``limit_visible_gpus``); under a JAX mesh, sharding replaces rank
  pinning, so this mainly serves mixed workloads.
- ``use_deterministic_ops``: ask XLA for bitwise-deterministic kernels.
"""

from __future__ import annotations

import os

import jax


def use_cpu():
    """Forces all computations onto the CPU backend (must be called
    before any device computation runs)."""
    jax.config.update("jax_platforms", "cpu")


def use_double_precision():
    """Enables float64 computation globally."""
    jax.config.update("jax_enable_x64", True)


def limit_visible_devices(device_index: int):
    """Makes the device with the given index the default device for
    dispatch (the analog of pinning one GPU per MPI rank in the
    reference; JAX mesh sharding normally makes this unnecessary)."""
    devices = jax.devices()
    if not 0 <= device_index < len(devices):
        raise ValueError(
            f"device index ({device_index}) must be non-negative and "
            f"less than the number of devices ({len(devices)})"
        )
    jax.config.update("jax_default_device", devices[device_index])


def use_deterministic_ops():
    """Requests bitwise-deterministic XLA kernels (must be called before
    the backend is initialized)."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_deterministic_ops"
    )
    os.environ["TF_DETERMINISTIC_OPS"] = "1"
