"""Multi-host distribution scaffolding.

The reference scales Parareal across hosts with MPI — one rank per time
slice, launched via ``mpiexec`` (/root/reference/pararealml/operators/
parareal/parareal_operator.py:108; /root/reference/Makefile:34-35). The
JAX equivalent is JAX's multi-process runtime: every host runs
the *same* program, :func:`initialize` connects them through a
coordinator, and ``jax.devices()`` then returns the devices of ALL
hosts, so a ``jax.sharding.Mesh`` built from it spans every host. The
``shard_map`` Parareal program needs no changes — XLA routes its
``all_gather`` over the interconnect within a host and the network
across hosts.

Launch recipe (one command per host)::

    # host 0 (the coordinator):
    python my_parareal_script.py --coordinator host0:1234 \
        --num-processes 2 --process-id 0
    # host 1:
    python my_parareal_script.py --coordinator host0:1234 \
        --num-processes 2 --process-id 1

with the script starting::

    from pararealml_tpu.utils.distributed import initialize, time_mesh
    initialize(coordinator, num_processes, process_id)
    parareal = PararealOperator(f, g, tol, devices=jax.devices())
    solution = parareal.solve(ivp)   # every process gets the full
                                     # trajectory, like the reference's
                                     # final MPI Allgather

On clusters that JAX can detect (e.g. under SLURM) the three
arguments can be omitted; elsewhere pass all three. A two-process CPU smoke test lives in
``tests/operators/parareal/test_distributed.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Connects this process to the multi-host JAX runtime.

    Must be called before any other JAX API touches the backend. Pass
    the coordinator's ``host:port``, the total process count, and this
    process's rank unless JAX's cluster detection finds them.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_distributed() -> bool:
    """Whether this process is part of a multi-process runtime."""
    return jax.process_count() > 1


def space_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("space",),
) -> Mesh:
    """A mesh for spatial domain decomposition (``FDMOperator``'s
    ``spatial_mesh``), 1D over ``space`` by default or reshaped to
    ``shape`` × ``axis_names`` for multi-axis grid partitions."""
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if n_devices is None and shape is not None:
        # a shape implies its own device count, so a (4, 2) mesh works
        # on a 16-device slice without an explicit n_devices
        n_devices = int(np.prod(tuple(shape)))
    if n_devices is not None:
        devices = devices[:n_devices]
    device_array = np.asarray(devices)
    if shape is not None:
        device_array = device_array.reshape(tuple(shape))
        if len(axis_names) != device_array.ndim:
            raise ValueError(
                f"axis_names {tuple(axis_names)} must name all "
                f"{device_array.ndim} mesh axes"
            )
    return Mesh(device_array, tuple(axis_names))


def time_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1D ``time`` mesh over the given devices (default: the global
    device list of all hosts), optionally truncated to ``n_devices``."""
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("time",))
