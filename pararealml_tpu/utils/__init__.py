"""Utilities. Checkpointing lives in :mod:`pararealml_tpu.utils.checkpoint`,
which needs flax and is imported only where it is used."""

from pararealml_tpu.utils.distributed import (
    initialize as initialize_distributed,
    is_distributed,
    time_mesh,
)
from pararealml_tpu.utils.rand import SEEDS, set_random_seed
from pararealml_tpu.utils.time import device_time, mesh_time, time

__all__ = [
    "SEEDS",
    "set_random_seed",
    "time",
    "device_time",
    "mesh_time",
    "initialize_distributed",
    "is_distributed",
    "time_mesh",
]
