"""Exact affine propagators: linear-problem trajectories as matmuls.

For a linear differential equation with static boundary conditions and an
explicit integrator, one FDM (or ODE) time step is an *affine* map of the
flattened state vector::

    y_{k+1} = S @ y_k + q

with a constant ``(dim, dim)`` matrix ``S`` and offset ``q`` (Dirichlet
application, Neumann ghost synthesis, and every explicit Runge-Kutta
stage are themselves affine, so the composition is too). This module
recovers ``(S, q)`` *exactly* by probing the generic step function with
the standard basis, then reformulates the trajectory as a scan of
matmuls against ``S``. The payoff is in the batched (``vmap``) case —
the one Parareal creates by stacking time slices: each scan step becomes
a single ``(B, dim) x (dim, dim)`` matmul, where the stencil formulation
of the same batched step is elementwise work with O(1) arithmetic
intensity scattered over many small fused ops. Only ``S`` itself
(``dim^2`` scalars) and the binary-power chain for the end-state map
(``log2(n)`` more matrices) ride in the compiled program, so program
size stays bounded regardless of trajectory length.

End states skip the interior entirely: ``y_n = P y_0 + r`` with
``(P, r)`` the ``n``-step composition, materialized once at build time
through the binary expansion of ``n``, so every Parareal end call is
ONE matvec (one ``(B, dim) x (dim, dim)`` matmul for a batch of
slices), and the composed map itself (``affine_slice_map``) lets the
Parareal operator run its corrective coarse sweeps as log-depth
doubling scans instead of ``n`` dependent solves.

This is the accelerator-side replacement for the reference's batched fine
solves inside Parareal (/root/reference/pararealml/operators/parareal/
parareal_operator.py:163: one fine solve per MPI rank per iteration);
sequential solves outside the parallel-in-time composition keep using
the stencil time-steppers, which are the honest sequential baselines.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pararealml_tpu.constrained_problem import ConstrainedProblem
from pararealml_tpu.differential_equation import LHS
from pararealml_tpu.expression import degree

# S alone is dim^2; beyond this the dense formulation loses to stencils
_MAX_DIM = 4096
# element budget for the stacked chunk powers [S^1..S^c] used to expand
# trajectory interiors chunk-at-a-time (64 MB of f32): caps both the
# compiled program's constant size and the per-chunk matmul width
_MAX_CHUNK_STACK_ELEMS = 16_777_216
# matmul precision: chained propagators amplify rounding, so every
# propagator matmul asks for full float32 (on GPUs this keeps float32
# matmuls off the TF32 tensor-core path, which keeps ~3 decimal digits)
_PRECISION = jax.lax.Precision.HIGHEST


def _all_symbol_arrays(symbols):
    arrays = [symbols.y]
    for name in (
        "y_gradient",
        "y_hessian",
        "y_divergence",
        "y_curl",
        "y_laplacian",
        "y_vector_laplacian",
    ):
        array = getattr(symbols, name)
        if array is not None:
            arrays.append(array)
    return arrays


def equation_system_is_affine(diff_eq) -> bool:
    """Whether every RHS expression is affine in the solution-dependent
    symbols (y and all its differential operators) with no explicit
    time dependence — the condition under which one explicit FDM step is
    an affine map of the state vector."""
    symbols = diff_eq.symbols
    t = symbols.t
    y_symbols = {
        s
        for array in _all_symbol_arrays(symbols)
        for s in np.asarray(array).flatten()
    }
    for expr in diff_eq.symbolic_equation_system.rhs:
        if t in expr.free_symbols:
            return False
        expr_degree = degree(expr, y_symbols)
        if expr_degree is None or expr_degree > 1:
            return False
    return True


def linear_propagator_applicable(
    cp: ConstrainedProblem, integrator, max_dim: int = _MAX_DIM
) -> bool:
    """Whether the affine-propagator formulation reproduces the generic
    step for this problem/integrator combination."""
    from pararealml_tpu.operators.fdm.numerical_integrator import (
        ExplicitMidpointMethod,
        ForwardEulerMethod,
        RK4,
    )

    diff_eq = cp.differential_equation
    if not isinstance(
        integrator, (ForwardEulerMethod, ExplicitMidpointMethod, RK4)
    ):
        return False
    eq_sys = diff_eq.symbolic_equation_system
    if eq_sys.equation_indices_by_type(LHS.Y_LAPLACIAN):
        # the Jacobi anti-Laplacian's data-dependent early exit breaks
        # exact affinity
        return False
    if diff_eq.x_dimension:
        if not cp.are_all_boundary_conditions_static:
            return False
        dim = int(np.prod(cp.y_shape(True)))
    else:
        dim = diff_eq.y_dimension
    if dim > max_dim:
        return False
    return equation_system_is_affine(diff_eq)


def probe_affine_step(
    step_fn: Callable, y_shape: Tuple[int, ...], dtype=None
) -> Tuple[jax.Array, jax.Array]:
    """Recovers ``(S, q)`` with ``step(y) == S @ vec(y) + q`` by probing
    ``step_fn(y, i, t)`` with the zero state and the standard basis, and
    verifies affinity on a random state (guarding against a dispatch
    bug routing a nonlinear problem here)."""
    if dtype is None:
        dtype = jnp.result_type(float)
    dim = int(np.prod(y_shape))

    def flat_step(y_flat):
        return step_fn(
            y_flat.reshape(y_shape).astype(dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0.0, dtype),
        ).reshape(dim)

    probe = jax.jit(
        lambda basis, zero: (
            jax.vmap(flat_step)(basis),
            flat_step(zero),
        )
    )
    cols, q = probe(jnp.eye(dim, dtype=dtype), jnp.zeros(dim, dtype))
    s_matrix = cols.T - q[:, jnp.newaxis]

    rng = np.random.default_rng(0)
    y_random = jnp.asarray(rng.standard_normal(dim), dtype)
    direct = np.asarray(jax.jit(flat_step)(y_random))
    # the verification matmul must itself run in full float32:
    # reduced-precision matmul passes carry ~1e-3 relative error — the
    # very threshold being tested
    via_affine = np.asarray(
        jnp.matmul(s_matrix, y_random, precision=_PRECISION) + q,
        np.float64,
    )
    scale = max(1.0, float(np.abs(direct).max()))
    deviation = float(np.abs(direct - via_affine).max()) / scale
    if not np.isfinite(deviation) or deviation > 1e-3:
        raise ValueError(
            "step function is not affine in the state (max relative "
            f"deviation {deviation:.2e}); the linear-propagator "
            "applicability check should have rejected this problem"
        )
    return s_matrix, q


def _binary_power_chain(s_matrix, q, n_steps: int):
    """``[(S^(2^i), r_i)]`` for every set bit needed to compose the
    ``n_steps``-step affine map, built by repeated squaring: the affine
    composition rule is ``(S2, q2) o (S1, q1) = (S2 S1, S2 q1 + q2)``."""

    @jax.jit
    def square(p, r):
        return (
            jnp.matmul(p, p, precision=_PRECISION),
            jnp.matmul(p, r[:, None], precision=_PRECISION)[:, 0] + r,
        )

    chain = []
    p, r = s_matrix, q
    bits = n_steps
    while bits:
        chain.append((p, r, bool(bits & 1)))
        bits >>= 1
        if bits:
            p, r = square(p, r)
    return chain


def build_linear_propagator_trajectory(
    cp: ConstrainedProblem,
    step_fn: Callable,
    n_steps: int,
    y_shape: Tuple[int, ...],
    dtype=None,
) -> Callable:
    """Builds ``trajectory(y, t_0) -> ys`` computing ``n_steps`` steps of
    the affine step map as a scan of matmuls against ``S``.

    The returned function is pure jnp, so it freely composes
    with ``vmap`` — under which each scan step is one large
    ``(B, dim) x (dim, dim)`` matmul over the batch of Parareal
    slices — and with ``shard_map``. It also exposes ``end_function``,
    an O(log n)-matvec map to the trajectory's final state for
    sequential sweeps that never need the interior.
    """
    if dtype is None:
        # follow the ambient default float width: f32 on accelerators,
        # f64 under jax_enable_x64 (the test suite's oracle precision)
        dtype = jnp.result_type(float)
    dim = int(np.prod(y_shape))
    s_matrix, q = probe_affine_step(step_fn, y_shape, dtype)
    # row-vector convention so a vmapped batch contracts as (B, dim) x
    # (dim, dim) without transposes at trace time
    s_t = jnp.asarray(s_matrix.T)
    chain = _binary_power_chain(s_matrix, q, n_steps)

    # chunked interior expansion: with the stacked powers
    # [S^1.T .. S^c.T] (precomputed once, (dim, c*dim) flattened), a
    # whole chunk of c trajectory states is ONE (B, dim) x (dim, c*dim)
    # matmul from the chunk-start state — the time axis itself is
    # parallelized within a chunk, cutting the serial scan length by c
    chunk = max(
        1, min(64, n_steps, _MAX_CHUNK_STACK_ELEMS // (dim * dim))
    )
    if chunk > 1 and n_steps % chunk:
        # prefer an exact divisor of n_steps within 2x of the cap: the
        # padded tail otherwise forces a [:n_steps] truncation copy of
        # the whole expanded trajectory plus up to chunk-1 wasted
        # states
        for candidate in range(chunk, chunk // 2, -1):
            if n_steps % candidate == 0:
                chunk = candidate
                break
    if chunk > 1:
        pow_ts, offsets = [s_t], [q]
        for _ in range(chunk - 1):
            pow_ts.append(
                jnp.matmul(pow_ts[-1], s_t, precision=_PRECISION)
            )
            offsets.append(
                jnp.matmul(offsets[-1], s_t, precision=_PRECISION) + q
            )
        pow_flat = jnp.stack(pow_ts, axis=1).reshape(dim, chunk * dim)
        offset_stack = jnp.stack(offsets, axis=0)
        n_chunks = -(-n_steps // chunk)

        # chunk-BOUNDARY states are themselves an affine recurrence in
        # the chunk index (z_{k+1} = S^c z_k + r_c), so they come from
        # a log-depth Hillis-Steele doubling scan over precomputed
        # (S^c)^(2^l) instead of a sequential chunk scan — and with
        # every chunk start known, ALL interiors are one batched
        # (n_chunks, dim) x (dim, c*dim) matmul. The whole
        # trajectory expansion then has O(log n_chunks) serial depth.
        # The doubling powers ride in the compiled program; past the
        # footprint cap the sequential chunk scan remains.
        boundary_levels = (n_chunks - 1).bit_length()
        # doubling shortens deep chunk scans but adds data formatting
        # on shallow ones, so shallow scans keep the sequential chunk
        # loop
        use_doubling = (
            n_chunks >= 16
            and boundary_levels * dim * dim * np.dtype(dtype).itemsize
            <= 128 * 2**20
        )
        if use_doubling:
            chunk_pt = pow_ts[chunk - 1]  # (S^c).T
            chunk_r = offsets[chunk - 1]
            boundary_pows = [chunk_pt]
            for _ in range(boundary_levels - 1):
                boundary_pows.append(
                    jnp.matmul(
                        boundary_pows[-1],
                        boundary_pows[-1],
                        precision=_PRECISION,
                    )
                )

    def trajectory(y, t_0=None):
        y_flat = jnp.asarray(y, dtype).reshape(dim)

        if chunk > 1:
            if use_doubling:
                # w_0 = S^c y + r_c seeds the prefix; v_k = z_{k+1}
                w = jnp.broadcast_to(
                    chunk_r, (n_chunks, dim)
                ).astype(dtype)
                w = w.at[0].add(
                    jnp.matmul(y_flat, chunk_pt, precision=_PRECISION)
                )
                v = w
                for level, ptl in enumerate(boundary_pows):
                    shift = 1 << level
                    shifted = jnp.concatenate(
                        [
                            jnp.zeros((shift, dim), v.dtype),
                            v[:-shift],
                        ],
                        axis=0,
                    )
                    v = v + jnp.matmul(
                        shifted, ptl, precision=_PRECISION
                    )
                starts = jnp.concatenate(
                    [y_flat[jnp.newaxis], v[:-1]], axis=0
                )
                ys = jnp.matmul(
                    starts, pow_flat, precision=_PRECISION
                ).reshape(n_chunks, chunk, dim) + offset_stack
                ys = ys.reshape(n_chunks * chunk, dim)[:n_steps]
            else:

                def body(carry, _):
                    states = jnp.matmul(
                        carry, pow_flat, precision=_PRECISION
                    ).reshape(chunk, dim) + offset_stack
                    return states[-1], states

                _, ys = jax.lax.scan(
                    body, y_flat, None, length=n_chunks
                )
                ys = ys.reshape(n_chunks * chunk, dim)[:n_steps]
        else:

            def body(carry, _):
                nxt = (
                    jnp.matmul(carry, s_t, precision=_PRECISION) + q
                )
                return nxt, nxt

            _, ys = jax.lax.scan(body, y_flat, None, length=n_steps)
        return ys.reshape((n_steps,) + tuple(y_shape)).astype(
            jnp.result_type(y)
        )

    # the composed n_steps-step affine map (P, r), materialized once at
    # build time by folding the binary chain (row-vector convention:
    # y_end = y @ P.T + r). It backs both the one-matmul end_function
    # below and affine_slice_map — the surface Parareal's doubling-scan
    # coarse sweeps consume (the corrective sweep y_{j+1} = P y_j +
    # (r + correction_j) is an affine recurrence in the slice index)
    p_total = jnp.eye(dim, dtype=dtype)
    r_total = jnp.zeros(dim, dtype=dtype)
    for p, r, take in chain:
        if take:
            p_total = jnp.matmul(p, p_total, precision=_PRECISION)
            r_total = (
                jnp.matmul(p, r_total[:, None], precision=_PRECISION)[
                    :, 0
                ]
                + r
            )
    p_total_t = p_total.T

    def end_state(y, t_0=None):
        """The trajectory's final state only — ONE matvec against the
        materialized ``n_steps``-step composed map, letting Parareal's
        per-iteration fine ends and (non-affine-sweep) corrective
        coarse sweeps skip the interior entirely. Under ``vmap`` the
        batch of Parareal slices contracts as a single
        ``(B, dim) x (dim, dim)`` matmul."""
        out = jnp.asarray(y, dtype).reshape(dim)
        out = jnp.matmul(out, p_total_t, precision=_PRECISION) + r_total
        return out.reshape(tuple(y_shape)).astype(jnp.result_type(y))

    trajectory.end_function = end_state
    trajectory.affine_slice_map = (p_total_t, r_total)
    return trajectory
