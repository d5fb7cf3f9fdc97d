"""The solver-operator interface.

Capability match for /root/reference/pararealml/operator.py:13-74, plus the
JAX-native :class:`JaxOperator` extension: operators that can expose their
whole solve as a pure, jit-traceable trajectory function participate in
fully-compiled composition (most importantly the single-program
``shard_map`` Parareal in
:mod:`pararealml_tpu.operators.parareal.parareal_operator`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import numpy as np

from pararealml_tpu.initial_value_problem import (
    InitialValueProblem,
    TemporalDomainInterval,
)
from pararealml_tpu.solution import Solution


class Operator:
    """Base class for solvers of initial value problems over a time
    interval with a fixed output step size."""

    def __init__(self, d_t: float, vertex_oriented: Optional[bool]):
        if d_t <= 0.0:
            raise ValueError("time step size must be greater than 0")
        self._d_t = d_t
        self._vertex_oriented = vertex_oriented

    @property
    def d_t(self) -> float:
        """The temporal step size of the operator."""
        return self._d_t

    @property
    def vertex_oriented(self) -> Optional[bool]:
        """Whether solutions are evaluated at mesh vertices or cell
        centers (None for pure ODE solvers)."""
        return self._vertex_oriented

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        """Solves the IVP and returns its :class:`Solution`."""
        raise NotImplementedError


class JaxOperator(Operator):
    """An operator whose solve is expressible as a pure jit-traceable
    function from the initial state to the full trajectory.

    This is the contract that lets the Parareal operator compile fine and
    coarse solvers into one XLA program spanning a device mesh.
    """

    def trajectory_function(
        self,
        cp,
        t_interval: TemporalDomainInterval,
        time_parallel: bool = False,
    ) -> Tuple[Callable[[jax.Array, jax.Array], jax.Array], np.ndarray]:
        """Returns ``(fn, t_coordinates)`` where ``fn(y_0, t_0)`` maps the
        (flattened-over-grid) initial state and the traced interval start
        time to the trajectory array of shape
        ``(len(t_coordinates), *y_shape)``.

        ``t_coordinates`` are the output times relative to
        ``t_interval[0]`` (excluding the initial time). The function must
        be traceable for any ``t_0`` so Parareal can reuse one compiled
        instance for every time slice.

        The function must also be ``vmap``-able, since Parareal batches
        several time slices per device through ``vmap``.

        :param time_parallel: whether the caller is a parallel-in-time
            composition (e.g. Parareal), in which case the operator may
            use trajectory formulations that are themselves parallel
            across time steps (such as affine propagator matmuls,
            :mod:`pararealml_tpu.ops.linear_propagator`) instead of
            sequential time-stepping; operators without such paths
            ignore it
        """
        raise NotImplementedError


def discretize_time_domain(
    t: TemporalDomainInterval, d_t: float
) -> np.ndarray:
    """Discretizes a time interval into whole steps of size ``d_t``
    (rounding the step count), returning ``steps + 1`` points."""
    t_0 = float(t[0])
    steps = int(round((t[1] - t_0) / d_t))
    return np.linspace(t_0, t_0 + steps * d_t, steps + 1)
