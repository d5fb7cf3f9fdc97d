"""Space x time parallel-in-time: Parareal with spatially decomposed
sub-solves, as one GSPMD program over a 2D device mesh.

The reference parallelizes time only (one MPI rank per slice,
/root/reference/pararealml/operators/parareal/parareal_operator.py:102-197)
and has no spatial scaling in any form. The compiled ``shard_map``
:class:`~pararealml_tpu.operators.parareal.parareal_operator.PararealOperator`
keeps that shape (time-axis sharding, per-device fine solves).

This module goes one level further: the whole Parareal schedule is
expressed as ordinary batched JAX — slices are a leading ``vmap`` axis —
and *annotated* with shardings instead of manually mapped, so XLA's SPMD
partitioner splits the slice batch over the mesh's ``time`` axis AND
every stencil evaluation over its ``space`` axis simultaneously. A pod
slice can therefore put, say, 4-way time x 8-way space parallelism on 32
chips: each device advances its share of the time slices on its shard of
the grid, with stencil halo exchanges riding the ``space`` axis and the
per-iteration correction exchange riding the ``time`` axis. Uneven grids
reuse the tail-padding machinery of
:mod:`pararealml_tpu.operators.fdm.padded_grid`, so real vertices evolve
exactly as in the single-device program.

The algorithm (initial coarse sweep, ends-only corrective iterations
with masked exactness, RMS-tolerance early termination inside the
``while_loop``, final fine materialization shifted onto the corrected
borders) mirrors the compiled ``PararealOperator`` program one-to-one;
only the execution mapping differs.
"""

from __future__ import annotations

import sys
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from pararealml_tpu.initial_value_problem import InitialValueProblem
from pararealml_tpu.operator import discretize_time_domain
from pararealml_tpu.operators.fdm.fdm_operator import FDMOperator
from pararealml_tpu.operators.parareal.parareal_operator import (
    PararealOperator,
    TerminationCondition,
    make_rms_termination,
)
from pararealml_tpu.solution import Solution


class SpaceTimePararealOperator(PararealOperator):
    """Classic Parareal over a ``(time, space)`` device mesh with
    spatially decomposed fine and coarse solves.

    Both operators must be :class:`FDMOperator` instances solving a PDE
    with static boundary conditions (the sub-solves are built from the
    FDM step machinery so they can run on tail-padded grids). The number
    of time slices must be divisible by the mesh's time-axis size; the
    grid need not divide the space-axis size.
    """

    def __init__(
        self,
        f: FDMOperator,
        g: FDMOperator,
        termination_condition: Optional[TerminationCondition] = None,
        max_iterations: int = sys.maxsize,
        num_time_slices: Optional[int] = None,
        mesh=None,
        time_axis: str = "time",
        spatial_partition: Optional[PartitionSpec] = None,
        relaxation: str = "f",
    ):
        """
        :param f: the fine (accurate, expensive) FDM operator
        :param g: the coarse (cheap) FDM operator
        :param termination_condition: as for :class:`PararealOperator`
            (callable predicates are not supported in the compiled
            program; pass a scalar or per-component tolerances)
        :param max_iterations: cap on the corrective iterations
        :param num_time_slices: number of time slices; defaults to the
            mesh's time-axis size
        :param mesh: a ``jax.sharding.Mesh`` whose ``time_axis`` axis
            shards the slice batch; every *other* axis is available for
            the spatial partition
        :param time_axis: the mesh axis name carrying time parallelism
        :param spatial_partition: a ``PartitionSpec`` over the leading
            spatial grid axes (defaults to sharding the first grid axis
            over the first non-time mesh axis, or no spatial sharding
            if the mesh is 1D)
        :param relaxation: ``"f"`` (classic Parareal) or ``"fcf"``
            (MGRIT-style — two slices of exactness per iteration for a
            second, equally parallel fine sweep plus per-slice coarse
            solves), matching :class:`PararealOperator`
        """
        if not isinstance(f, FDMOperator) or not isinstance(
            g, FDMOperator
        ):
            raise ValueError(
                "space-time Parareal requires FDMOperator fine and "
                "coarse operators (their step machinery supports "
                "spatially decomposed, tail-padded grids)"
            )
        if mesh is None:
            raise ValueError("a (time, space) device mesh is required")
        if time_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has no '{time_axis}' axis (axes: "
                f"{mesh.axis_names})"
            )
        if callable(termination_condition):
            raise ValueError(
                "callable termination conditions are not supported in "
                "the space-time compiled program; pass a scalar or "
                "per-component tolerances"
            )
        super().__init__(
            f,
            g,
            termination_condition=termination_condition,
            max_iterations=max_iterations,
            num_time_slices=(
                num_time_slices
                if num_time_slices is not None
                else mesh.shape[time_axis]
            ),
            devices=list(mesh.devices.flatten()),
            relaxation=relaxation,
        )
        self._mesh = mesh
        self._time_axis = time_axis
        self._spatial_partition = spatial_partition
        self._st_compiled_cache = {}

    # -- plan ---------------------------------------------------------------

    def _resolve_space_partition(self, x_dimension: int):
        """Per-grid-axis PartitionSpec entries and shard counts for the
        spatial axes (the time axis is reserved for slices)."""
        from pararealml_tpu.operators.fdm.padded_grid import (
            resolve_spatial_partition,
        )

        spec = self._spatial_partition
        if spec is None:
            non_time = [
                name
                for name in self._mesh.axis_names
                if name != self._time_axis
            ]
            spec = (
                PartitionSpec(non_time[0])
                if non_time
                else PartitionSpec()
            )
        return resolve_spatial_partition(
            self._mesh,
            spec,
            x_dimension,
            forbidden_axes=(self._time_axis,),
        )

    # -- solving ------------------------------------------------------------

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        if not parallel_enabled:
            return self._f.solve(ivp)
        if jax.process_count() > 1:
            raise NotImplementedError(
                "the space-time Parareal fetches the sharded "
                "trajectory to the host, which requires all mesh "
                "devices to be addressable by this process; for "
                "multi-host runs use PararealOperator (its shard_map "
                "program replicates the output across processes)"
            )
        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        if diff_eq.x_dimension == 0:
            raise ValueError(
                "space-time Parareal requires a PDE (no spatial "
                "dimensions to decompose); use PararealOperator for "
                "ODE systems"
            )
        if not cp.are_all_boundary_conditions_static:
            raise ValueError(
                "space-time Parareal requires static boundary "
                "conditions"
            )
        n = self._num_time_slices
        time_size = self._mesh.shape[self._time_axis]
        if n % time_size:
            raise ValueError(
                f"number of time slices ({n}) must be divisible by "
                f"the mesh's time-axis size ({time_size})"
            )

        t_interval = ivp.t_interval
        slice_duration = (t_interval[1] - t_interval[0]) / n
        self._validate_step_sizes(slice_duration)

        y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))

        cache_key = (
            id(cp),
            n,
            round(float(t_interval[0]), 12),
            round(float(slice_duration), 12),
        )
        entry = self._st_compiled_cache.get(cache_key)
        if entry is None or entry[0] is not cp:
            entry = (
                cp,
                self._build_space_time_program(
                    cp, float(t_interval[0]), slice_duration, n
                ),
            )
            self._st_compiled_cache[cache_key] = entry
        program, y_sharding, real_shape, padded_shape = entry[1]

        if padded_shape != real_shape:
            from pararealml_tpu.operators.fdm.padded_grid import (
                pad_state,
            )

            y_0 = pad_state(y_0, real_shape, padded_shape)
        y_0 = jax.device_put(y_0, y_sharding)

        ys = np.asarray(program(y_0))
        if padded_shape != real_shape:
            ys = ys[
                (slice(None),) + tuple(slice(0, s) for s in real_shape)
            ]

        t = discretize_time_domain(t_interval, self._f.d_t)
        return Solution(
            ivp, t[1:], ys, vertex_oriented=True, d_t=self._f.d_t
        )

    def _evict_losing_compiled(self, best_n: int) -> None:
        super()._evict_losing_compiled(best_n)
        for key in list(self._st_compiled_cache):
            if key[1] != best_n:
                del self._st_compiled_cache[key]

    def trajectory_function(
        self,
        cp,
        t_interval,
        time_parallel: bool = False,
    ):
        raise NotImplementedError(
            "the space-time Parareal does not expose a reusable "
            "trajectory function: its program is specific to one "
            "(time, space) mesh and problem horizon. Use solve(), or "
            "PararealOperator.trajectory_function for a time-only "
            "composable program."
        )

    # -- program construction -------------------------------------------

    def _build_space_time_program(
        self, cp, t_0: float, slice_duration: float, n: int
    ):
        mesh = self._mesh
        time_axis = self._time_axis
        diff_eq = cp.differential_equation
        x_dimension = diff_eq.x_dimension

        space_entries, shard_counts = self._resolve_space_partition(
            x_dimension
        )

        from pararealml_tpu.operators.fdm.numerical_differentiator import (
            ThreePointCentralDifferenceMethod,
        )
        from pararealml_tpu.operators.fdm.padded_grid import (
            padded_spatial_shape,
        )

        real_shape = tuple(cp.mesh.vertices_shape)
        padded_shape = padded_spatial_shape(real_shape, shard_counts)
        build_padded = (
            padded_shape if padded_shape != real_shape else None
        )
        if build_padded is not None and not all(
            isinstance(
                op._differentiator, ThreePointCentralDifferenceMethod
            )
            for op in (self._f, self._g)
        ):
            raise ValueError(
                "space-time Parareal over shard counts that do not "
                "divide the grid requires the three-point central "
                "differentiator (the padded-grid boundary handling is "
                "implemented for its stencils)"
            )

        fine_steps = round(slice_duration / self._f.d_t)
        coarse_steps = round(slice_duration / self._g.d_t)
        fine_step = self._f._build_step_function(
            cp,
            t_0,
            fine_steps * n,
            static_only=True,
            padded_shape=build_padded,
        )
        coarse_step = self._g._build_step_function(
            cp,
            t_0,
            coarse_steps * n,
            static_only=True,
            padded_shape=build_padded,
        )
        fine_trajectory = self._f._build_trajectory_fn(
            cp,
            t_0,
            fine_steps,
            static_only=True,
            padded_shape=build_padded,
        )

        def end_function(step_fn, steps, d_t):
            def end(y, t_start):
                def body(y_carry, k):
                    return step_fn(y_carry, k, t_start + d_t * k), None

                y_end, _ = jax.lax.scan(
                    body, y, jnp.arange(steps)
                )
                return y_end

            return end

        fine_end = end_function(fine_step, fine_steps, self._f.d_t)
        coarse_end = end_function(
            coarse_step, coarse_steps, self._g.d_t
        )

        tolerances = self._tolerance_vector(diff_eq.y_dimension)
        # FCF advances exactness two slices per iteration, so all n
        # borders are exact after ceil(n / 2) iterations
        exact_after = -(-n // 2) if self._relaxation == "fcf" else n
        iterations = min(self._max_iterations, exact_after)

        # y: (*grid, components); batch axis prepended for slices
        state_spec = PartitionSpec(*space_entries, None)
        batched_spec = PartitionSpec(
            time_axis, *space_entries, None
        )
        replicated_batch_spec = PartitionSpec(
            None, *space_entries, None
        )
        y_sharding = NamedSharding(mesh, state_spec)
        batched_sharding = NamedSharding(mesh, batched_spec)
        replicated_batch_sharding = NamedSharding(
            mesh, replicated_batch_spec
        )

        slice_starts = t_0 + slice_duration * jnp.arange(n)

        # the border arrays span the PADDED grid whose pad vertices
        # carry diff exactly 0, so the raw per-component RMS would be
        # the true (real-vertex) RMS diluted by sqrt(real / padded) —
        # terminating early relative to PararealOperator at the same
        # tolerance. Scaling the tolerances by that factor makes the
        # padded test exactly equivalent to the real-vertex criterion.
        if tolerances is not None and padded_shape != real_shape:
            dilution = np.sqrt(
                float(np.prod(real_shape)) / float(np.prod(padded_shape))
            )
            tolerances = np.asarray(tolerances, dtype=float) * dilution
        termination = make_rms_termination(tolerances)

        def batched_ends(end_fn, starts):
            # the heavy stage: shard slices over `time`, stencils over
            # the space axes; replicate the results for the sweep (the
            # analog of the shard_map program's all_gather)
            starts = jax.lax.with_sharding_constraint(
                starts, batched_sharding
            )
            ends = jax.vmap(end_fn)(starts, slice_starts)
            return jax.lax.with_sharding_constraint(
                ends, replicated_batch_sharding
            )

        fcf = self._relaxation == "fcf"

        def program(y_init):
            def sweep(y, t_start):
                y_end = coarse_end(y, t_start)
                return y_end, y_end

            _, coarse_ends = jax.lax.scan(sweep, y_init, slice_starts)
            y_borders = jnp.concatenate(
                [y_init[jnp.newaxis], coarse_ends]
            )

            # NOTE: this schedule (exactness masks, FCF z-shift, final
            # border shift) intentionally mirrors the shard_map program
            # in parareal_operator.py:_build_compiled_program — a
            # change to either copy's masks or sweep order must be
            # applied to both (the cross-operator bit-identity tests in
            # tests/operators/parareal/test_space_time.py enforce it)
            def iteration(carry):
                i, y_borders, coarse_ends, _ = carry
                fine_ends = batched_ends(fine_end, y_borders[:-1])
                if fcf:
                    # FCF relaxation: the first fine sweep is the
                    # F-relaxation; correct border j + 1 from the
                    # fine-propagated state z_j = F(u_{j-1}) (z_0 =
                    # u_0) — the same schedule as the shard_map
                    # program's FCF branch
                    z = jnp.concatenate(
                        [y_borders[:1], fine_ends[:-1]]
                    )
                    corrections = batched_ends(
                        fine_end, z
                    ) - batched_ends(coarse_end, z)
                else:
                    corrections = fine_ends - coarse_ends
                old_ends = y_borders[1:]

                def corrective_sweep(j, state):
                    y_borders, coarse_ends = state
                    re_predicted = coarse_end(
                        y_borders[j], slice_starts[j]
                    )
                    new_coarse_end = jnp.where(
                        (j > i) if not fcf else (j >= i),
                        re_predicted,
                        coarse_ends[j],
                    )
                    coarse_ends = coarse_ends.at[j].set(
                        new_coarse_end
                    )
                    updated_border = new_coarse_end + corrections[j]
                    y_borders = y_borders.at[j + 1].set(
                        jnp.where(
                            j >= i, updated_border, y_borders[j + 1]
                        )
                    )
                    return y_borders, coarse_ends

                y_borders, coarse_ends = jax.lax.fori_loop(
                    i, n, corrective_sweep, (y_borders, coarse_ends)
                )
                converged = termination(old_ends, y_borders[1:])
                return (i + 1, y_borders, coarse_ends, converged)

            def keep_iterating(carry):
                i, _, _, converged = carry
                return jnp.logical_and(
                    i < iterations, jnp.logical_not(converged)
                )

            _, y_borders, _, _ = jax.lax.while_loop(
                keep_iterating,
                iteration,
                (
                    jnp.asarray(0, jnp.int32),
                    y_borders,
                    coarse_ends,
                    jnp.asarray(False),
                ),
            )

            # materialize the fine trajectories once from the final
            # borders and shift them onto the corrected borders — the
            # same continuity semantics as the shard_map program
            trajectory_starts = jax.lax.with_sharding_constraint(
                y_borders[:-1], batched_sharding
            )
            sub_y_fine = jax.vmap(fine_trajectory)(
                trajectory_starts, slice_starts
            )
            shifts = y_borders[1:] - sub_y_fine[:, -1]
            sub_y_fine = sub_y_fine + shifts[:, jnp.newaxis]
            return sub_y_fine.reshape(
                (n * fine_steps,) + sub_y_fine.shape[2:]
            )

        compiled = jax.jit(
            program,
            in_shardings=y_sharding,
            out_shardings=NamedSharding(
                mesh, PartitionSpec(None, *space_entries, None)
            ),
        )
        return compiled, y_sharding, real_shape, padded_shape
