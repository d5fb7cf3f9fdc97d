"""Jit-compiled adaptive ODE solving.

Capability match for /root/reference/pararealml/operators/ode/
ode_operator.py:12-85, which delegates to SciPy's ``solve_ivp``. Here the
whole adaptive Runge-Kutta integration — embedded error estimation,
PI-style step-size control, dense-output interpolation onto the output
grid — is a single ``lax.while_loop`` program compiled by XLA, so it runs
on the device with no host round-trips and can be nested inside larger compiled
programs (e.g. the ``shard_map`` Parareal).

Supported methods: adaptive explicit ``"RK45"`` (Dormand-Prince 5(4)
with its quartic dense-output interpolant, SciPy's default), ``"RK23"``
(Bogacki-Shampine 3(2)) and ``"DOP853"``; adaptive implicit ``"Radau"``
(Radau IIA 5th order) and ``"BDF"`` (variable-order 1-5 NDF), both with
jitted simplified-Newton inner solves for stiff systems; plus
fixed-step ``"RK4"``, ``"Midpoint"`` and
``"Euler"``. This matches the reference's SciPy method coverage
(/root/reference/pararealml/operators/ode/ode_operator.py:17-44) for
both non-stiff and stiff problems.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from pararealml_tpu.expression import compile_expressions
from pararealml_tpu.initial_value_problem import InitialValueProblem
from pararealml_tpu.operator import JaxOperator, discretize_time_domain
from pararealml_tpu.solution import Solution


class RKTableau(NamedTuple):
    """An explicit embedded Runge-Kutta tableau, optionally with a
    dense-output interpolation matrix.

    Users may pass an instance directly as :class:`ODEOperator`'s
    ``method`` to integrate with custom coefficients — the JAX-native
    counterpart of the reference's acceptance of custom SciPy
    ``OdeSolver`` classes (/root/reference/pararealml/operators/ode/
    ode_operator.py:17-44). ``a``, ``b``, ``c`` are the standard Butcher
    arrays (``a`` as a tuple of per-stage tuples), ``e`` the embedded
    error weights over the stages plus the FSAL evaluation, and ``p``
    the dense-output polynomial matrix; with ``p=None``, output points
    are interpolated by a cubic Hermite spline over each accepted step
    (SciPy's fallback interpolant order).
    """

    a: tuple
    b: tuple
    c: tuple
    e: tuple
    p: Optional[tuple]
    error_exponent: float


# internal alias (the public name is re-exported by operators.ode)
_RKTableau = RKTableau


_RK45 = _RKTableau(
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0),
    e=(
        71 / 57600,
        0.0,
        -71 / 16695,
        71 / 1920,
        -17253 / 339200,
        22 / 525,
        -1 / 40,
    ),
    p=(
        (
            1.0,
            -8048581381 / 2820520608,
            8663915743 / 2820520608,
            -12715105075 / 11282082432,
        ),
        (0.0, 0.0, 0.0, 0.0),
        (
            0.0,
            131558114200 / 32700410799,
            -68118460800 / 10900136933,
            87487479700 / 32700410799,
        ),
        (
            0.0,
            -1754552775 / 470086768,
            14199869525 / 1410260304,
            -10690763975 / 1880347072,
        ),
        (
            0.0,
            127303824393 / 49829197408,
            -318862633887 / 49829197408,
            701980252875 / 199316789632,
        ),
        (
            0.0,
            -282668133 / 205662961,
            2019193451 / 616988883,
            -1453857185 / 822651844,
        ),
        (0.0, 40617522 / 29380423, -110615467 / 29380423,
         69997945 / 29380423),
    ),
    error_exponent=-1.0 / 5.0,
)

_RK23 = _RKTableau(
    a=((), (1 / 2,), (0.0, 3 / 4)),
    b=(2 / 9, 1 / 3, 4 / 9),
    c=(0.0, 1 / 2, 3 / 4),
    e=(5 / 72, -1 / 12, -1 / 9, 1 / 8),
    p=(
        (1.0, -4 / 3, 5 / 9),
        (0.0, 1.0, -2 / 3),
        (0.0, 4 / 3, -8 / 9),
        (0.0, -1.0, 1.0),
    ),
    error_exponent=-1.0 / 3.0,
)

_ADAPTIVE_TABLEAUS = {"RK45": _RK45, "RK23": _RK23}
_FIXED_STEP_METHODS = ("RK4", "Midpoint", "Euler")
_DOP853 = "DOP853"
_RADAU = "Radau"
_BDF = "BDF"
_LSODA = "LSODA"

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


def _rms_norm(x):
    return jnp.sqrt(jnp.mean(jnp.square(x)))


def _initial_step_size(
    fn, t0, y0, f0, max_step, rtol, atol, error_exponent
):
    """Hairer-style automatic initial step size selection (the algorithm
    behind SciPy's ``_select_initial_step``)."""
    scale = atol + jnp.abs(y0) * rtol
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    h0 = jnp.where(
        (d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / jnp.maximum(d1, 1e-30)
    )
    y1 = y0 + h0 * f0
    f1 = fn(t0 + h0, y1)
    d2 = _rms_norm((f1 - f0) / scale) / h0
    h1 = jnp.where(
        jnp.maximum(d1, d2) <= 1e-15,
        jnp.maximum(1e-6, h0 * 1e-3),
        (0.01 / jnp.maximum(d1, d2)) ** -error_exponent,
    )
    return jnp.minimum(jnp.minimum(100.0 * h0, h1), max_step)


def _build_adaptive_integrator(
    fn: Callable,
    tableau: _RKTableau,
    t_offsets: np.ndarray,
    rtol: float,
    atol: float,
    max_step: float,
    first_step: Optional[float],
    max_steps: int = 1_000_000,
):
    """Builds a jit-traceable function ``(y0, t0) -> (ys, status)`` that
    adaptively integrates ``y' = fn(t, y)`` and interpolates the solution
    onto ``t0 + t_offsets`` via the tableau's dense-output polynomial.
    ``status`` is 0 on success, 1 when the step budget was exhausted.
    """
    n_stages = len(tableau.b)
    n_out = len(t_offsets)
    t_span = float(t_offsets[-1])

    def integrate(y0: jax.Array, t0: jax.Array):
        dtype = jnp.result_type(y0)
        y0 = jnp.asarray(y0, dtype)
        t0 = jnp.asarray(t0, dtype)
        t_out = t0 + jnp.asarray(t_offsets, dtype)
        t_bound = t0 + t_span
        eps = jnp.asarray(1e-10 * max(1.0, abs(t_span)), dtype)

        f0 = fn(t0, y0)
        if first_step is None:
            h0 = _initial_step_size(
                fn, t0, y0, f0, max_step, rtol, atol,
                tableau.error_exponent,
            )
        else:
            h0 = jnp.asarray(first_step, dtype)
        h0 = jnp.minimum(h0, jnp.asarray(t_span, dtype))

        p_matrix = (
            None if tableau.p is None else jnp.asarray(tableau.p, dtype)
        )
        b_vec = jnp.asarray(tableau.b, dtype)
        e_vec = jnp.asarray(tableau.e, dtype)

        def attempt_step(t, y, f, h):
            """One embedded RK step attempt; returns the candidate state,
            the error norm, and the stage derivatives."""
            ks = [f]
            for s in range(1, n_stages):
                a_row = tableau.a[s]
                dy = h * sum(
                    a_row[j] * ks[j] for j in range(s) if a_row[j] != 0.0
                )
                ks.append(fn(t + tableau.c[s] * h, y + dy))
            y_new = y + h * sum(
                b_vec[j] * ks[j] for j in range(n_stages)
            )
            f_new = fn(t + h, y_new)
            k_full = jnp.stack(ks + [f_new])
            err = h * jnp.tensordot(e_vec, k_full, axes=1)
            scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
            return y_new, f_new, k_full, _rms_norm(err / scale)

        def fill_outputs(carry):
            """Writes every output point covered by the accepted step via
            the dense-output interpolant."""
            t, t_new, h, y, k_full, out_idx, ys = carry

            if p_matrix is not None:
                q = jnp.tensordot(k_full.T, p_matrix, axes=1)
            else:
                # no dense-output matrix (custom tableau): cubic
                # Hermite over the accepted step from (y, f) at both
                # ends, expressed in the same y + h * q @ powers form
                f_start = k_full[0]
                f_end = k_full[-1]
                # (y_new - y) / h, from the tableau weights
                d = jnp.tensordot(
                    b_vec, k_full[: len(tableau.b)], axes=1
                )
                q = jnp.stack(
                    [
                        f_start,
                        3.0 * d - 2.0 * f_start - f_end,
                        -2.0 * d + f_start + f_end,
                    ],
                    axis=-1,
                )
            order = q.shape[-1]

            def cond(c):
                idx, _ = c
                return (idx < n_out) & (t_out[idx] <= t_new + eps)

            def body(c):
                idx, ys_acc = c
                theta = (t_out[idx] - t) / h
                powers = jnp.cumprod(
                    jnp.full((order,), theta, dtype)
                )
                y_interp = y + h * q @ powers
                return idx + 1, ys_acc.at[idx].set(y_interp)

            return jax.lax.while_loop(cond, body, (out_idx, ys))

        def loop_cond(state):
            _, _, _, _, out_idx, _, n_steps, status = state
            return (out_idx < n_out) & (status == 0) & (
                n_steps < max_steps
            )

        def loop_body(state):
            t, y, f, h, out_idx, ys, n_steps, status = state

            h = jnp.minimum(h, jnp.maximum(t_bound - t, eps))
            y_new, f_new, k_full, error_norm = attempt_step(t, y, f, h)
            accepted = error_norm < 1.0

            factor = jnp.where(
                error_norm == 0.0,
                _MAX_FACTOR,
                jnp.clip(
                    _SAFETY * error_norm ** tableau.error_exponent,
                    _MIN_FACTOR,
                    _MAX_FACTOR,
                ),
            )
            h_next = jnp.minimum(h * factor, max_step)

            t_new = t + h
            out_idx_new, ys_new = jax.lax.cond(
                accepted,
                fill_outputs,
                lambda c: (c[5], c[6]),
                (t, t_new, h, y, k_full, out_idx, ys),
            )

            return (
                jnp.where(accepted, t_new, t),
                jnp.where(accepted, y_new, y),
                jnp.where(accepted, f_new, f),
                h_next,
                out_idx_new,
                ys_new,
                n_steps + 1,
                status,
            )

        ys_init = jnp.zeros((n_out,) + y0.shape, dtype)
        init_state = (t0, y0, f0, h0, 0, ys_init, 0, 0)
        final = jax.lax.while_loop(loop_cond, loop_body, init_state)
        _, _, _, _, out_idx, ys, n_steps, _ = final
        status = jnp.where(out_idx < n_out, 1, 0)
        return ys, status

    return integrate


def _build_dop853_integrator(
    fn: Callable,
    t_offsets: np.ndarray,
    rtol: float,
    atol: float,
    max_step: float,
    first_step: Optional[float],
    max_steps: int = 1_000_000,
):
    """Builds a jit-traceable adaptive Dormand-Prince 8(5,3) integrator
    with the degree-7 dense-output interpolant.

    The published Hairer coefficient tables are loaded as numerical data
    from SciPy's ``dop853_coefficients`` module; the stepping, the
    combined 5th/3rd-order error norm, and the interpolant construction
    follow the published DOP853 algorithm, compiled into a single
    ``lax.while_loop``.
    """
    from scipy.integrate._ivp import dop853_coefficients as dop

    n_stages = dop.N_STAGES  # 12
    n_stages_extended = dop.N_STAGES_EXTENDED  # 16
    interp_power = dop.INTERPOLATOR_POWER  # 7
    a_matrix = np.asarray(dop.A)
    b_vec = np.asarray(dop.B)
    c_vec = np.asarray(dop.C)
    e3_vec = np.asarray(dop.E3)
    e5_vec = np.asarray(dop.E5)
    d_matrix = np.asarray(dop.D)
    error_exponent = -1.0 / 8.0

    n_out = len(t_offsets)
    t_span = float(t_offsets[-1])

    def integrate(y0: jax.Array, t0: jax.Array):
        dtype = jnp.result_type(y0)
        y0 = jnp.asarray(y0, dtype)
        t0 = jnp.asarray(t0, dtype)
        t_out = t0 + jnp.asarray(t_offsets, dtype)
        t_bound = t0 + t_span
        eps = jnp.asarray(1e-10 * max(1.0, abs(t_span)), dtype)
        n_dim = y0.shape[0]

        f0 = fn(t0, y0)
        if first_step is None:
            h0 = _initial_step_size(
                fn, t0, y0, f0, max_step, rtol, atol, error_exponent
            )
        else:
            h0 = jnp.asarray(first_step, dtype)
        h0 = jnp.minimum(h0, jnp.asarray(t_span, dtype))

        a_mat = jnp.asarray(a_matrix, dtype)
        b = jnp.asarray(b_vec, dtype)
        e3 = jnp.asarray(e3_vec, dtype)
        e5 = jnp.asarray(e5_vec, dtype)
        d_mat = jnp.asarray(d_matrix, dtype)

        def attempt_step(t, y, f, h):
            ks = [f]
            for s in range(1, n_stages):
                dy = h * sum(
                    a_matrix[s, j] * ks[j]
                    for j in range(s)
                    if a_matrix[s, j] != 0.0
                )
                ks.append(fn(t + c_vec[s] * h, y + dy))
            k12 = jnp.stack(ks)  # (12, n)
            y_new = y + h * jnp.tensordot(b, k12, axes=1)
            f_new = fn(t + h, y_new)
            k13 = jnp.concatenate([k12, f_new[jnp.newaxis]])  # (13, n)

            scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
            err5 = jnp.tensordot(e5, k13, axes=1) / scale
            err3 = jnp.tensordot(e3, k13, axes=1) / scale
            err5_norm_2 = jnp.sum(jnp.square(err5))
            err3_norm_2 = jnp.sum(jnp.square(err3))
            denom = err5_norm_2 + 0.01 * err3_norm_2
            error_norm = jnp.where(
                denom > 0.0,
                jnp.abs(h)
                * err5_norm_2
                / jnp.sqrt(jnp.maximum(denom, 1e-300) * n_dim),
                jnp.asarray(0.0, dtype),
            )
            return y_new, f_new, k13, error_norm

        def fill_outputs(carry):
            t, t_new, h, y, y_new, f_new, k13, out_idx, ys = carry

            def compute_and_fill(args):
                out_idx, ys = args
                # extended stages for the dense-output interpolant
                k_rows = [k13[s] for s in range(n_stages)]
                k_rows.append(k13[n_stages])  # f_new at row 12
                for s in range(n_stages + 1, n_stages_extended):
                    dy = h * sum(
                        a_matrix[s, j] * k_rows[j]
                        for j in range(s)
                        if a_matrix[s, j] != 0.0
                    )
                    k_rows.append(fn(t + c_vec[s] * h, y + dy))
                k_ext = jnp.stack(k_rows)  # (16, n)

                f_old = k_ext[0]
                delta_y = y_new - y
                f_rows = [
                    delta_y,
                    h * f_old - delta_y,
                    2.0 * delta_y - h * (f_new + f_old),
                ]
                f_tail = h * jnp.tensordot(d_mat, k_ext, axes=1)
                interp_f = jnp.concatenate(
                    [jnp.stack(f_rows), f_tail]
                )  # (7, n)

                def cond(c):
                    idx, _ = c
                    return (idx < n_out) & (t_out[idx] <= t_new + eps)

                def body(c):
                    idx, ys_acc = c
                    x = (t_out[idx] - t) / h
                    y_interp = jnp.zeros_like(y)
                    for i in range(interp_power):
                        y_interp = y_interp + interp_f[
                            interp_power - 1 - i
                        ]
                        y_interp = y_interp * (
                            x if i % 2 == 0 else 1.0 - x
                        )
                    y_interp = y_interp + y
                    return idx + 1, ys_acc.at[idx].set(y_interp)

                return jax.lax.while_loop(cond, body, (out_idx, ys))

            need_fill = (out_idx < n_out) & (
                t_out[jnp.minimum(out_idx, n_out - 1)] <= t_new + eps
            )
            return jax.lax.cond(
                need_fill,
                compute_and_fill,
                lambda args: args,
                (out_idx, ys),
            )

        def loop_cond(state):
            _, _, _, _, out_idx, _, n_steps, status = state
            return (out_idx < n_out) & (status == 0) & (
                n_steps < max_steps
            )

        def loop_body(state):
            t, y, f, h, out_idx, ys, n_steps, status = state
            h = jnp.minimum(h, jnp.maximum(t_bound - t, eps))
            y_new, f_new, k13, error_norm = attempt_step(t, y, f, h)
            accepted = error_norm < 1.0

            factor = jnp.where(
                error_norm == 0.0,
                _MAX_FACTOR,
                jnp.clip(
                    _SAFETY * error_norm**error_exponent,
                    _MIN_FACTOR,
                    _MAX_FACTOR,
                ),
            )
            h_next = jnp.minimum(h * factor, max_step)

            t_new = t + h
            out_idx_new, ys_new = jax.lax.cond(
                accepted,
                fill_outputs,
                lambda c: (c[7], c[8]),
                (t, t_new, h, y, y_new, f_new, k13, out_idx, ys),
            )

            return (
                jnp.where(accepted, t_new, t),
                jnp.where(accepted, y_new, y),
                jnp.where(accepted, f_new, f),
                h_next,
                out_idx_new,
                ys_new,
                n_steps + 1,
                status,
            )

        ys_init = jnp.zeros((n_out,) + y0.shape, dtype)
        final = jax.lax.while_loop(
            loop_cond, loop_body, (t0, y0, f0, h0, 0, ys_init, 0, 0)
        )
        _, _, _, _, out_idx, ys, _, _ = final
        return ys, jnp.where(out_idx < n_out, 1, 0)

    return integrate


def _build_radau_integrator(
    fn: Callable,
    t_offsets: np.ndarray,
    rtol: float,
    atol: float,
    max_step: float,
    first_step: Optional[float],
    max_steps: int = 1_000_000,
):
    """Builds a jit-traceable implicit adaptive Radau IIA 5th-order
    integrator for stiff systems.

    The algorithm follows the published RADAU5 scheme (Hairer & Wanner,
    "Solving ODEs II", Sec. IV.8; the same algorithm behind SciPy's
    ``Radau``): the 3-stage collocation system is transformed by the
    eigendecomposition of the Butcher matrix into one real and one
    complex linear system per simplified-Newton iteration, with the
    Jacobian obtained by ``jax.jacfwd``, a third-order embedded error
    estimate smoothed by ``(MU/h I - J)^-1``, a Gustafsson-style
    predictive step controller, and the collocation cubic for dense
    output — all compiled into a single ``lax.while_loop``.
    """
    s6 = np.sqrt(6.0)
    c_nodes = np.array([(4 - s6) / 10, (4 + s6) / 10, 1.0])
    e_vec = np.array([-13 - 7 * s6, -13 + 7 * s6, -1.0]) / 3
    mu_real = 3 + 3 ** (2 / 3) - 3 ** (1 / 3)
    mu_complex = (
        3
        + 0.5 * (3 ** (1 / 3) - 3 ** (2 / 3))
        - 0.5j * (3 ** (5 / 6) + 3 ** (7 / 6))
    )
    t_matrix = np.array(
        [
            [0.09443876248897524, -0.14125529502095421,
             0.03002919410514742],
            [0.25021312296533332, 0.20412935229379994,
             -0.38294211275726192],
            [1.0, 1.0, 0.0],
        ]
    )
    ti_matrix = np.array(
        [
            [4.17871859155190428, 0.32768282076106237,
             0.52337644549944951],
            [-4.17871859155190428, -0.32768282076106237,
             0.47662355450055044],
            [0.50287263494578682, -2.57192694985560522,
             0.59603920482822492],
        ]
    )
    ti_real = ti_matrix[0]
    ti_complex = ti_matrix[1] + 1j * ti_matrix[2]
    p_matrix = np.array(
        [
            [13 / 3 + 7 * s6 / 3, -23 / 3 - 22 * s6 / 3,
             10 / 3 + 5 * s6],
            [13 / 3 - 7 * s6 / 3, -23 / 3 + 22 * s6 / 3,
             10 / 3 - 5 * s6],
            [1 / 3, -8 / 3, 10 / 3],
        ]
    )
    newton_maxiter = 6

    n_out = len(t_offsets)
    t_span = float(t_offsets[-1])

    def integrate(y0: jax.Array, t0: jax.Array):
        dtype = jnp.result_type(y0)
        cdtype = jnp.result_type(dtype, jnp.complex64)
        # SciPy's dtype-aware Newton floor: with x64 disabled the
        # integrator runs in float32, whose much larger eps must raise
        # the convergence floor or the corrector wastes iterations
        # chasing sub-precision residuals
        newton_tol = max(
            10 * np.finfo(np.dtype(dtype)).eps / rtol,
            min(0.03, rtol ** 0.5),
        )
        y0 = jnp.asarray(y0, dtype)
        t0 = jnp.asarray(t0, dtype)
        t_out = t0 + jnp.asarray(t_offsets, dtype)
        t_bound = t0 + t_span
        eps = jnp.asarray(1e-10 * max(1.0, abs(t_span)), dtype)
        n_dim = y0.shape[0]
        identity = jnp.eye(n_dim, dtype=dtype)

        c_arr = jnp.asarray(c_nodes, dtype)
        e_arr = jnp.asarray(e_vec, dtype)
        t_arr = jnp.asarray(t_matrix, dtype)
        ti_r = jnp.asarray(ti_real, dtype)
        ti_c = jnp.asarray(ti_complex, cdtype)
        p_arr = jnp.asarray(p_matrix, dtype)

        jac_fn = jax.jacfwd(fn, argnums=1)

        f0 = fn(t0, y0)
        if first_step is None:
            h0 = _initial_step_size(
                fn, t0, y0, f0, max_step, rtol, atol, -1.0 / 4.0
            )
        else:
            h0 = jnp.asarray(first_step, dtype)
        h0 = jnp.minimum(h0, jnp.asarray(t_span, dtype))

        def newton_solve(t, y, h, z0, scale, jac):
            """Simplified-Newton solve of the collocation system; the
            Jacobian is fresh per step so no refresh retry is needed."""
            m_real = mu_real / h
            m_complex = mu_complex / h
            a_real = m_real * identity - jac
            a_complex = m_complex * identity.astype(cdtype) - jac

            w0 = jnp.tensordot(
                jnp.asarray(ti_matrix, dtype), z0, axes=1
            )

            def cond(state):
                k, _, _, _, converged, diverged = state
                return (
                    (k < newton_maxiter) & ~converged & ~diverged
                )

            def body(state):
                k, w, z, dw_norm_old, _, _ = state
                f_stages = jnp.stack(
                    [
                        fn(t + c_arr[i] * h, y + z[i])
                        for i in range(3)
                    ]
                )
                bad = ~jnp.all(jnp.isfinite(f_stages))
                f_real = (
                    jnp.tensordot(ti_r, f_stages, axes=1)
                    - m_real * w[0]
                )
                f_complex = jnp.tensordot(
                    ti_c, f_stages.astype(cdtype), axes=1
                ) - m_complex * (w[1] + 1j * w[2])

                dw_real = jnp.linalg.solve(a_real, f_real)
                dw_complex = jnp.linalg.solve(a_complex, f_complex)
                dw = jnp.stack(
                    [dw_real, dw_complex.real, dw_complex.imag]
                )

                dw_norm = _rms_norm(dw / scale)
                have_rate = k > 0
                rate = jnp.where(
                    have_rate,
                    dw_norm / jnp.maximum(dw_norm_old, 1e-300),
                    jnp.asarray(0.0, dtype),
                )
                diverging = have_rate & (
                    (rate >= 1.0)
                    | (
                        rate ** (newton_maxiter - k)
                        / jnp.maximum(1.0 - rate, 1e-10)
                        * dw_norm
                        > newton_tol
                    )
                )
                diverging = diverging | bad

                w_new = jnp.where(diverging, w, w + dw)
                z_new = jnp.tensordot(t_arr, w_new, axes=1)
                converged = ~diverging & (
                    (dw_norm == 0.0)
                    | (
                        have_rate
                        & (
                            rate
                            / jnp.maximum(1.0 - rate, 1e-10)
                            * dw_norm
                            < newton_tol
                        )
                    )
                )
                return (
                    k + 1,
                    w_new,
                    z_new,
                    dw_norm,
                    converged,
                    diverging,
                )

            state = (
                0,
                w0,
                z0,
                jnp.asarray(0.0, dtype),
                jnp.asarray(False),
                jnp.asarray(False),
            )
            k, _, z, _, converged, _ = jax.lax.while_loop(
                cond, body, state
            )
            return converged, k, z

        def fill_outputs(carry):
            """Writes every output point covered by the accepted step
            via the collocation cubic."""
            t, t_new, h, y, q, out_idx, ys = carry

            def cond(c):
                idx, _ = c
                return (idx < n_out) & (t_out[idx] <= t_new + eps)

            def body(c):
                idx, ys_acc = c
                x = (t_out[idx] - t) / h
                powers = jnp.cumprod(jnp.full((3,), x, dtype))
                y_interp = y + q @ powers
                return idx + 1, ys_acc.at[idx].set(y_interp)

            return jax.lax.while_loop(cond, body, (out_idx, ys))

        def predict_factor(h_abs, h_abs_old, err, err_old):
            multiplier = jnp.where(
                (h_abs_old > 0) & (err > 0),
                h_abs
                / jnp.maximum(h_abs_old, 1e-300)
                * (
                    jnp.maximum(err_old, 1e-300)
                    / jnp.maximum(err, 1e-300)
                )
                ** 0.25,
                jnp.asarray(1.0, dtype),
            )
            return jnp.minimum(1.0, multiplier) * jnp.maximum(
                err, 1e-300
            ) ** -0.25

        def loop_cond(state):
            out_idx, n_steps, status = state[-3], state[-2], state[-1]
            return (
                (out_idx < n_out) & (status == 0) & (n_steps < max_steps)
            )

        def loop_body(state):
            (
                t,
                y,
                f,
                h_abs,
                h_abs_old,
                err_old,
                y_prev,
                t_prev,
                h_prev,
                q_prev,
                have_sol,
                rejected,
                ys,
                out_idx,
                n_steps,
                status,
            ) = state

            h = jnp.clip(h_abs, eps, jnp.maximum(t_bound - t, eps))
            t_new = t + h

            # stage-increment prediction from the previous collocation
            # polynomial (Hairer's extrapolated starting values)
            def predicted_z0():
                x = (t + h * c_arr - t_prev)[:, jnp.newaxis] / h_prev
                powers = jnp.cumprod(
                    jnp.broadcast_to(x, (3, 3)), axis=1
                )  # (stage, power)
                return (
                    y_prev + powers @ q_prev.T - y
                )

            z0 = jnp.where(
                have_sol,
                predicted_z0(),
                jnp.zeros((3, n_dim), dtype),
            )

            scale = atol + jnp.abs(y) * rtol
            jac = jac_fn(t, y)
            converged, n_iter, z = newton_solve(
                t, y, h, z0, scale, jac
            )

            y_new = y + z[-1]
            ze = jnp.tensordot(e_arr, z, axes=1) / h
            a_real = mu_real / h * identity - jac
            error = jnp.linalg.solve(a_real, f + ze)
            scale_new = atol + jnp.maximum(
                jnp.abs(y), jnp.abs(y_new)
            ) * rtol
            error_norm = _rms_norm(error / scale_new)
            # a smoothed re-estimate after a rejection (stiffness-proof
            # error estimate, Hairer IV.8)
            def refined_error():
                refreshed = jnp.linalg.solve(
                    a_real, fn(t, y + error) + ze
                )
                return _rms_norm(refreshed / scale_new)

            error_norm = jnp.where(
                rejected & (error_norm > 1.0) & converged,
                refined_error(),
                error_norm,
            )

            safety = (
                0.9
                * (2 * newton_maxiter + 1)
                / (2 * newton_maxiter + n_iter)
            )
            accepted = converged & (error_norm < 1.0)

            # step-size update: divergence halves the step, rejection
            # shrinks by the predictive factor, acceptance grows by it
            factor = predict_factor(
                h_abs, h_abs_old, error_norm, err_old
            )
            h_next = jnp.where(
                ~converged,
                0.5 * h_abs,
                jnp.where(
                    accepted,
                    jnp.minimum(
                        h_abs * jnp.minimum(10.0, safety * factor),
                        max_step,
                    ),
                    h_abs * jnp.maximum(0.2, safety * factor),
                ),
            )

            q_new = z.T @ p_arr  # (n, 3) collocation cubic
            out_idx_new, ys_new = jax.lax.cond(
                accepted,
                fill_outputs,
                lambda c: (c[5], c[6]),
                (t, t_new, h, y, q_new, out_idx, ys),
            )

            f_new = jnp.where(accepted, fn(t_new, y_new), f)
            status_new = jnp.where(
                h_next < eps * 10.0, 2, status
            )
            return (
                jnp.where(accepted, t_new, t),
                jnp.where(accepted, y_new, y),
                f_new,
                h_next,
                jnp.where(accepted, h_abs, h_abs_old),
                jnp.where(accepted, error_norm, err_old),
                jnp.where(accepted, y, y_prev),
                jnp.where(accepted, t, t_prev),
                jnp.where(accepted, h, h_prev),
                jnp.where(accepted, q_new, q_prev),
                have_sol | accepted,
                ~accepted,
                ys_new,
                out_idx_new,
                n_steps + 1,
                status_new,
            )

        ys_init = jnp.zeros((n_out,) + y0.shape, dtype)
        init_state = (
            t0,
            y0,
            f0,
            h0,
            jnp.asarray(0.0, dtype),
            jnp.asarray(0.0, dtype),
            y0,
            t0,
            jnp.asarray(1.0, dtype),
            jnp.zeros((n_dim, 3), dtype),
            jnp.asarray(False),
            jnp.asarray(False),
            ys_init,
            0,
            0,
            0,
        )
        final = jax.lax.while_loop(loop_cond, loop_body, init_state)
        ys, out_idx, status = final[-4], final[-3], final[-1]
        status = jnp.where(
            (out_idx < n_out) & (status == 0), 1, status
        )
        return ys, status

    return integrate


def _build_bdf_integrator(
    fn: Callable,
    t_offsets: np.ndarray,
    rtol: float,
    atol: float,
    max_step: float,
    first_step: Optional[float],
    max_steps: int = 1_000_000,
):
    """Builds a jit-traceable variable-order (1-5) BDF/NDF integrator
    for stiff systems.

    The algorithm is the quasi-constant-step-size NDF scheme of Shampine
    & Reichelt (the SIAM "MATLAB ODE Suite" paper; the same algorithm
    behind SciPy's ``BDF``): backward differences propagated through
    step- and order-changes by the ``R(order, factor)`` transform,
    simplified-Newton corrector solves of ``I - c J``, a truncation
    error estimate from the corrector increment, and order selection by
    comparing error norms at orders ``k-1, k, k+1`` — all compiled into
    a single ``lax.while_loop``. The traced ``order`` operates on
    fixed-shape difference arrays via block-diagonal masking of the
    full 5th-order transform matrices.
    """
    max_order = 5
    newton_maxiter = 4
    kappa = np.array([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0])
    gamma_np = np.hstack(
        (0.0, np.cumsum(1.0 / np.arange(1, max_order + 1)))
    )
    alpha_np = (1 - kappa) * gamma_np
    error_const_np = kappa * gamma_np + 1.0 / np.arange(
        1, max_order + 2
    )
    n_out = len(t_offsets)
    t_span = float(t_offsets[-1])

    # the factor-change transform entries depend only on (i, j), so the
    # R matrix for any order <= 5 is the top-left block of the full one
    row_idx = np.arange(max_order + 1)[:, None]
    col_idx = np.arange(max_order + 1)[None, :]
    u_full = np.cumprod(
        np.where(
            row_idx == 0,
            1.0,
            np.where(
                col_idx == 0,
                0.0,
                (row_idx - 1.0 - col_idx) / np.maximum(row_idx, 1),
            ),
        ),
        axis=0,
    )  # compute_R(5, factor=1)

    def integrate(y0: jax.Array, t0: jax.Array):
        dtype = jnp.result_type(y0)
        y0 = jnp.asarray(y0, dtype)
        t0 = jnp.asarray(t0, dtype)
        t_out = t0 + jnp.asarray(t_offsets, dtype)
        t_bound = t0 + t_span
        eps = jnp.asarray(1e-10 * max(1.0, abs(t_span)), dtype)
        # the smallest meaningful step is float-spacing-based (as in
        # SciPy); BDF legitimately dives far below Radau's heuristic
        # floor inside relaxation-oscillation transition layers
        min_h = jnp.asarray(
            10 * np.finfo(np.dtype(dtype)).eps * max(1.0, abs(t_span)),
            dtype,
        )
        # SciPy's dtype-aware Newton floor (see the Radau counterpart)
        newton_tol = max(
            10 * np.finfo(np.dtype(dtype)).eps / rtol,
            min(0.03, rtol ** 0.5),
        )
        n_dim = y0.shape[0]
        identity = jnp.eye(n_dim, dtype=dtype)

        gamma = jnp.asarray(gamma_np, dtype)
        alpha = jnp.asarray(alpha_np, dtype)
        error_const = jnp.asarray(error_const_np, dtype)
        u_mat = jnp.asarray(u_full, dtype)
        rows6 = jnp.arange(max_order + 1)
        rows8 = jnp.arange(max_order + 3)
        i_grid = rows6[:, None]
        j_grid = rows6[None, :]
        eye6 = jnp.eye(max_order + 1, dtype=dtype)

        jac_fn = jax.jacfwd(fn, argnums=1)

        def compute_r(factor):
            """``compute_R(5, factor)``: cumulative products of the
            difference-rescaling multipliers down each column."""
            m = jnp.where(
                i_grid == 0,
                jnp.asarray(1.0, dtype),
                jnp.where(
                    j_grid == 0,
                    jnp.asarray(0.0, dtype),
                    (i_grid - 1.0 - factor * j_grid)
                    / jnp.maximum(i_grid, 1),
                ),
            )
            return jnp.cumprod(m, axis=0)

        def change_d(d_arr, order, factor):
            """Rescales ``D[:order + 1]`` for a step-size change by
            ``factor``, leaving higher difference rows untouched
            (block-diagonal masking of the full transform)."""
            in_block = (i_grid <= order) & (j_grid <= order)
            r_b = jnp.where(in_block, compute_r(factor), eye6)
            u_b = jnp.where(in_block, u_mat, eye6)
            transform = (r_b @ u_b).T
            head = jnp.tensordot(
                transform, d_arr[: max_order + 1], axes=1
            )
            return d_arr.at[: max_order + 1].set(head)

        def newton_solve(t_new, y_predict, c, psi, scale, jac):
            """Simplified-Newton corrector solve of the BDF algebraic
            system (fresh Jacobian per step, so no refresh retry)."""
            a_mat = identity - c * jac

            def cond(state):
                k, _, _, _, converged, diverged = state
                return (k < newton_maxiter) & ~converged & ~diverged

            def body(state):
                k, y, d, dy_norm_old, _, _ = state
                f = fn(t_new, y)
                bad = ~jnp.all(jnp.isfinite(f))
                dy = jnp.linalg.solve(a_mat, c * f - psi - d)
                dy_norm = _rms_norm(dy / scale)
                have_rate = k > 0
                rate = jnp.where(
                    have_rate,
                    dy_norm / jnp.maximum(dy_norm_old, 1e-300),
                    jnp.asarray(0.0, dtype),
                )
                diverging = bad | (
                    have_rate
                    & (
                        (rate >= 1.0)
                        | (
                            rate ** (newton_maxiter - k)
                            / jnp.maximum(1.0 - rate, 1e-10)
                            * dy_norm
                            > newton_tol
                        )
                    )
                )
                y_new = jnp.where(diverging, y, y + dy)
                d_new = jnp.where(diverging, d, d + dy)
                converged = ~diverging & (
                    (dy_norm == 0.0)
                    | (
                        have_rate
                        & (
                            rate
                            / jnp.maximum(1.0 - rate, 1e-10)
                            * dy_norm
                            < newton_tol
                        )
                    )
                )
                return (
                    k + 1,
                    y_new,
                    d_new,
                    dy_norm,
                    converged,
                    diverging,
                )

            state = (
                0,
                y_predict,
                jnp.zeros_like(y_predict),
                jnp.asarray(0.0, dtype),
                jnp.asarray(False),
                jnp.asarray(False),
            )
            k, y, d, _, converged, _ = jax.lax.while_loop(
                cond, body, state
            )
            return converged, k, y, d

        def fill_outputs(carry):
            """Writes every output point covered by the accepted step
            via the backward-difference interpolant (the BDF dense
            output), with terms beyond the current order masked out."""
            t_new, h, order, d_arr, out_idx, ys = carry
            term_idx = jnp.arange(max_order)

            def cond(c):
                idx, _ = c
                return (idx < n_out) & (t_out[idx] <= t_new + eps)

            def body(c):
                idx, ys_acc = c
                x = (t_out[idx] - (t_new - h * term_idx)) / (
                    h * (term_idx + 1)
                )
                p = jnp.cumprod(
                    jnp.where(term_idx < order, x, 1.0)
                )
                p = jnp.where(term_idx < order, p, 0.0)
                y_interp = d_arr[0] + jnp.tensordot(
                    p, d_arr[1 : max_order + 1], axes=1
                )
                return idx + 1, ys_acc.at[idx].set(y_interp)

            return jax.lax.while_loop(cond, body, (out_idx, ys))

        f0 = fn(t0, y0)
        if first_step is None:
            h0 = _initial_step_size(
                fn, t0, y0, f0, max_step, rtol, atol, -1.0 / 2.0
            )
        else:
            h0 = jnp.asarray(first_step, dtype)
        h0 = jnp.minimum(h0, jnp.asarray(min(t_span, max_step), dtype))

        d_init = (
            jnp.zeros((max_order + 3, n_dim), dtype)
            .at[0]
            .set(y0)
            .at[1]
            .set(f0 * h0)
        )

        def loop_cond(state):
            out_idx, n_steps, status = state[-3], state[-2], state[-1]
            return (
                (out_idx < n_out)
                & (status == 0)
                & (n_steps < max_steps)
            )

        def loop_body(state):
            (
                t,
                y,
                d_arr,
                order,
                h_abs,
                n_eq,
                ys,
                out_idx,
                n_steps,
                status,
            ) = state

            # clamp the step to the integration boundary, rescaling the
            # differences for the shortened step
            h = jnp.clip(h_abs, min_h, jnp.maximum(t_bound - t, min_h))
            clamped = h < h_abs
            d_arr = jax.lax.cond(
                clamped,
                lambda d: change_d(d, order, h / h_abs),
                lambda d: d,
                d_arr,
            )
            n_eq = jnp.where(clamped, 0, n_eq)
            t_new = t + h

            order_mask = (rows8 <= order)[:, None]
            y_predict = jnp.sum(
                jnp.where(order_mask, d_arr, 0.0), axis=0
            )
            scale = atol + rtol * jnp.abs(y_predict)
            gamma_masked = jnp.where(
                (rows6 >= 1) & (rows6 <= order), gamma, 0.0
            )
            psi = (
                jnp.tensordot(
                    gamma_masked, d_arr[: max_order + 1], axes=1
                )
                / alpha[order]
            )
            c = h / alpha[order]

            jac = jac_fn(t_new, y_predict)
            converged, n_iter, y_new, d_new = newton_solve(
                t_new, y_predict, c, psi, scale, jac
            )

            scale_new = atol + rtol * jnp.abs(y_new)
            error_norm = _rms_norm(
                error_const[order] * d_new / scale_new
            )
            safety = (
                0.9
                * (2 * newton_maxiter + 1)
                / (2 * newton_maxiter + n_iter)
            )
            accepted = converged & (error_norm <= 1.0)

            reject_factor = jnp.where(
                ~converged,
                jnp.asarray(0.5, dtype),
                jnp.maximum(
                    0.2,
                    safety
                    * error_norm
                    ** (-1.0 / (order.astype(dtype) + 1.0)),
                ),
            )

            def rejected_branch(args):
                d_arr, ys, out_idx = args
                return (
                    change_d(d_arr, order, reject_factor),
                    order,
                    h * reject_factor,
                    jnp.asarray(0, n_eq.dtype),
                    ys,
                    out_idx,
                )

            def accepted_branch(args):
                d_arr, ys, out_idx = args
                # update the backward differences with the corrector
                # increment: D[k+2] = d - D[k+1]; D[k+1] = d;
                # D[i] += D[i+1] for i = k..0 (a reversed cumulative
                # sum over the leading rows)
                d_arr = d_arr.at[order + 2].set(
                    d_new - d_arr[order + 1]
                )
                d_arr = d_arr.at[order + 1].set(d_new)
                lead_mask = (rows8 <= order + 1)[:, None]
                masked = jnp.where(lead_mask, d_arr, 0.0)
                suffix = jnp.flip(
                    jnp.cumsum(jnp.flip(masked, 0), axis=0), 0
                )
                d_arr = jnp.where(lead_mask, suffix, d_arr)

                out_idx_new, ys_new = fill_outputs(
                    (t_new, h, order, d_arr, out_idx, ys)
                )

                n_eq_new = n_eq + 1

                # order selection once order + 1 equal steps confirm
                # the error estimates at orders k-1 and k+1
                error_m_norm = jnp.where(
                    order > 1,
                    _rms_norm(
                        error_const[order - 1]
                        * d_arr[order]
                        / scale_new
                    ),
                    jnp.asarray(jnp.inf, dtype),
                )
                error_p_norm = jnp.where(
                    order < max_order,
                    _rms_norm(
                        error_const[order + 1]
                        * d_arr[order + 2]
                        / scale_new
                    ),
                    jnp.asarray(jnp.inf, dtype),
                )
                norms = jnp.stack(
                    [error_m_norm, error_norm, error_p_norm]
                )
                exponents = -1.0 / (
                    order.astype(dtype) + jnp.arange(3, dtype=dtype)
                )
                factors = jnp.maximum(norms, 1e-300) ** exponents
                factors = jnp.where(
                    norms == 0.0, jnp.asarray(jnp.inf, dtype), factors
                )

                adapt = n_eq_new >= order + 1
                delta = (jnp.argmax(factors) - 1).astype(order.dtype)
                order_new = jnp.where(adapt, order + delta, order)
                grow_factor = jnp.minimum(
                    jnp.minimum(10.0, safety * jnp.max(factors)),
                    max_step / jnp.maximum(h, 1e-300),
                )
                d_arr = jax.lax.cond(
                    adapt,
                    lambda d: change_d(d, order_new, grow_factor),
                    lambda d: d,
                    d_arr,
                )
                h_next = jnp.where(adapt, h * grow_factor, h)
                n_eq_new = jnp.where(adapt, 0, n_eq_new)
                return (
                    d_arr,
                    order_new,
                    h_next,
                    n_eq_new,
                    ys_new,
                    out_idx_new,
                )

            (
                d_arr,
                order_next,
                h_next,
                n_eq_next,
                ys,
                out_idx,
            ) = jax.lax.cond(
                accepted,
                accepted_branch,
                rejected_branch,
                (d_arr, ys, out_idx),
            )

            status_new = jnp.where(h_next < min_h, 2, status)
            return (
                jnp.where(accepted, t_new, t),
                jnp.where(accepted, y_new, y),
                d_arr,
                order_next,
                h_next,
                n_eq_next,
                ys,
                out_idx,
                n_steps + 1,
                status_new,
            )

        ys_init = jnp.zeros((n_out,) + y0.shape, dtype)
        init_state = (
            t0,
            y0,
            d_init,
            jnp.asarray(1, jnp.int32),
            h0,
            jnp.asarray(0, jnp.int32),
            ys_init,
            0,
            0,
            0,
        )
        final = jax.lax.while_loop(loop_cond, loop_body, init_state)
        ys, out_idx, status = final[-4], final[-3], final[-1]
        status = jnp.where(
            (out_idx < n_out) & (status == 0), 1, status
        )
        return ys, status

    return integrate


def _build_fixed_step_integrator(
    fn: Callable, method: str, t_offsets: np.ndarray
):
    """Builds ``(y0, t0) -> (ys, status)`` taking one explicit RK step per
    output interval via ``lax.scan``."""
    d_t = float(t_offsets[0]) if len(t_offsets) == 1 else float(
        t_offsets[1] - t_offsets[0]
    )
    n_out = len(t_offsets)

    def step(t, y):
        if method == "Euler":
            return y + d_t * fn(t, y)
        if method == "Midpoint":
            k1 = fn(t, y)
            return y + d_t * fn(t + d_t / 2, y + (d_t / 2) * k1)
        k1 = fn(t, y)
        k2 = fn(t + d_t / 2, y + (d_t / 2) * k1)
        k3 = fn(t + d_t / 2, y + (d_t / 2) * k2)
        k4 = fn(t + d_t, y + d_t * k3)
        return y + (d_t / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    def integrate(y0: jax.Array, t0: jax.Array):
        dtype = jnp.result_type(y0)
        y0 = jnp.asarray(y0, dtype)
        ts = t0 + jnp.asarray(t_offsets, dtype) - d_t

        def scan_body(y, t):
            y_next = step(t, y)
            return y_next, y_next

        _, ys = jax.lax.scan(scan_body, y0, ts, length=n_out)
        return ys, jnp.asarray(0)

    return integrate


def _build_lsoda_integrator(
    fn: Callable,
    t_offsets: np.ndarray,
    rtol: float,
    atol: float,
    max_step: float,
    first_step: Optional[float],
    stiffness_threshold: float = 2000.0,
):
    """Builds a jit-traceable integrator with automatic stiff/non-stiff
    method selection — the JAX-native counterpart of the reference's
    ``"LSODA"`` pass-through to SciPy (/root/reference/pararealml/
    operators/ode/ode_operator.py:17-44).

    SciPy's LSODA switches between Adams and BDF *per step*; a traced
    per-step switch would put both correctors inside every loop
    iteration, so this implementation decides *per solve* instead: a
    cheap probe estimates the spectral radius ``rho`` of the Jacobian
    along a short explicit burst (a burst that overflows is itself
    conclusive evidence of stiffness), and ``lax.cond`` dispatches the
    whole solve to the compiled RK45 or BDF integrator. Both branches
    are compiled once; only the selected one executes at run time —
    under ``lax.cond``, XLA skips the untaken branch's computation.
    The decision metric ``rho * t_span`` approximates the number of
    stability-limited explicit steps the solve would need.
    """
    nonstiff = _build_adaptive_integrator(
        fn, _RK45, t_offsets, rtol, atol, max_step, first_step
    )
    stiff = _build_bdf_integrator(
        fn, t_offsets, rtol, atol, max_step, first_step
    )
    t_span = float(t_offsets[-1])
    jac_fn = jax.jacfwd(fn, argnums=1)
    n_burst = 16
    n_power_iters = 12

    def integrate(y0: jax.Array, t0: jax.Array):
        dtype = jnp.result_type(y0)
        y0 = jnp.asarray(y0, dtype)
        t0 = jnp.asarray(t0, dtype)
        h_burst = jnp.asarray(t_span / 512.0, dtype)

        def rk4_step(y, t):
            k1 = fn(t, y)
            k2 = fn(t + h_burst / 2, y + h_burst / 2 * k1)
            k3 = fn(t + h_burst / 2, y + h_burst / 2 * k2)
            k4 = fn(t + h_burst, y + h_burst * k3)
            return y + h_burst / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

        def spectral_radius(t, y):
            jac = jac_fn(t, y)

            def power_iter(v, _):
                w = jac @ v
                norm = jnp.linalg.norm(w)
                return w / jnp.maximum(norm, 1e-30), norm

            v0 = jnp.ones_like(y) / jnp.sqrt(
                jnp.asarray(y.shape[0], dtype)
            )
            _, norms = jax.lax.scan(
                power_iter, v0, None, length=n_power_iters
            )
            return norms[-1]

        def burst_body(carry, i):
            y, t = carry
            rho = spectral_radius(t, y)
            y_next = rk4_step(y, t)
            return (y_next, t + h_burst), rho

        (y_end, _), rhos = jax.lax.scan(
            burst_body, (y0, t0), jnp.arange(n_burst)
        )
        rho_max = jnp.max(rhos)
        burst_diverged = jnp.logical_not(
            jnp.all(jnp.isfinite(y_end))
        )
        is_stiff = jnp.logical_or(
            burst_diverged,
            rho_max * t_span > stiffness_threshold,
        )

        def run_stiff(args):
            ys, status = stiff(*args)
            return ys, jnp.asarray(status, jnp.int32)

        def run_nonstiff(args):
            ys, status = nonstiff(*args)
            return ys, jnp.asarray(status, jnp.int32)

        return jax.lax.cond(
            is_stiff, run_stiff, run_nonstiff, (y0, t0)
        )

    return integrate


class ODEOperator(JaxOperator):
    """A fully jit-compiled ODE initial-value-problem solver."""

    def __init__(
        self,
        method: Union[str, "RKTableau", Callable],
        d_t: float,
        first_step: Optional[float] = None,
        max_step: float = np.inf,
        atol: float = 1e-6,
        rtol: float = 1e-3,
    ):
        """
        :param method: "RK45", "RK23" or "DOP853" (adaptive explicit),
            "Radau" or "BDF" (adaptive implicit, for stiff systems),
            "LSODA" (automatic stiff/non-stiff selection, see
            :func:`_build_lsoda_integrator`), "RK4", "Midpoint" or
            "Euler" (fixed step at ``d_t``); alternatively a custom
            :class:`RKTableau` instance (adaptive embedded RK with
            user-supplied coefficients), or a callable
            ``(fn, t_offsets, rtol, atol, max_step, first_step) ->
            integrate`` building a jit-traceable
            ``(y0, t0) -> (ys, status)`` integrator — the counterparts
            of the reference's acceptance of any SciPy method string or
            ``OdeSolver`` class (/root/reference/pararealml/operators/
            ode/ode_operator.py:17-44)
        :param d_t: the temporal step size of the output grid
        :param first_step: optional initial integration step size
        :param max_step: the maximum allowed integration step size
        :param atol: absolute local-error tolerance
        :param rtol: relative local-error tolerance
        """
        if (
            not isinstance(method, RKTableau)
            and not callable(method)
            and method not in _ADAPTIVE_TABLEAUS
            and method not in _FIXED_STEP_METHODS
            and method not in (_DOP853, _RADAU, _BDF, _LSODA)
        ):
            supported = (
                sorted(_ADAPTIVE_TABLEAUS)
                + [_DOP853, _RADAU, _BDF, _LSODA]
                + list(_FIXED_STEP_METHODS)
            )
            raise ValueError(
                f"unsupported method '{method}'; expected one of "
                f"{supported}, an RKTableau, or a builder callable"
            )
        super().__init__(d_t, None)
        self._method = method
        self._first_step = first_step
        self._max_step = max_step
        self._atol = atol
        self._rtol = rtol
        self._compiled_cache = {}

    def _build_integrator(self, fn: Callable, t_offsets) -> Callable:
        if isinstance(self._method, RKTableau):
            return _build_adaptive_integrator(
                fn,
                self._method,
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        if callable(self._method):
            return self._method(
                fn,
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        if self._method == _LSODA:
            return _build_lsoda_integrator(
                fn,
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        if self._method in _ADAPTIVE_TABLEAUS:
            return _build_adaptive_integrator(
                fn,
                _ADAPTIVE_TABLEAUS[self._method],
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        if self._method == _DOP853:
            return _build_dop853_integrator(
                fn,
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        if self._method == _RADAU:
            return _build_radau_integrator(
                fn,
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        if self._method == _BDF:
            return _build_bdf_integrator(
                fn,
                t_offsets,
                self._rtol,
                self._atol,
                self._max_step,
                self._first_step,
            )
        return _build_fixed_step_integrator(fn, self._method, t_offsets)

    def _make_rhs_function(self, diff_eq) -> Callable:
        sym = diff_eq.symbols
        rhs = diff_eq.symbolic_equation_system.rhs
        symbols = [sym.t, *sym.y]
        rhs_lambda = compile_expressions(rhs, symbols)

        def d_y_over_d_t(t, y):
            values = rhs_lambda([t, *(y[i] for i in range(len(sym.y)))])
            return jnp.stack([jnp.asarray(v, y.dtype) for v in values])

        return d_y_over_d_t

    def trajectory_function(
        self,
        cp,
        t_interval,
        time_parallel: bool = False,
    ) -> Tuple[Callable, np.ndarray]:
        diff_eq = cp.differential_equation
        if diff_eq.x_dimension != 0:
            raise ValueError("initial value problem must be an ODE")

        t = discretize_time_domain(t_interval, self._d_t)
        if len(t) < 2:
            raise ValueError(
                "time interval must span at least one full time step"
            )
        t_offsets = t[1:] - t[0]
        fn = self._make_rhs_function(diff_eq)
        integrate = self._build_integrator(fn, t_offsets)

        def trajectory(y0, t0):
            ys, _ = integrate(y0, t0)
            return ys

        return trajectory, t[1:]

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        if diff_eq.x_dimension != 0:
            raise ValueError("initial value problem must be an ODE")

        t = discretize_time_domain(ivp.t_interval, self._d_t)
        if len(t) < 2:
            raise ValueError(
                "time interval must span at least one full time step"
            )
        t_offsets = tuple(np.round(t[1:] - t[0], 12))

        # the equation object is stored with the compiled function to
        # pin its id (CPython address reuse could otherwise alias a new
        # equation onto a stale compiled solver) and to guard explicitly
        cache_key = (id(diff_eq), t_offsets)
        entry = self._compiled_cache.get(cache_key)
        if entry is None or entry[0] is not diff_eq:
            fn = self._make_rhs_function(diff_eq)
            entry = (
                diff_eq,
                jax.jit(self._build_integrator(fn, t[1:] - t[0])),
            )
            self._compiled_cache[cache_key] = entry

        integrate = entry[1]
        y0 = jnp.asarray(ivp.initial_condition.discrete_y_0())
        ys, status = integrate(y0, t[0])
        status = int(status)
        if status != 0:
            messages = {
                1: "step budget exhausted before reaching the end of "
                   "the time interval",
                2: "step size collapsed below the resolvable minimum "
                   "(the problem may be singular or too stiff for the "
                   "requested tolerances)",
            }
            raise ValueError(
                "error solving initial value problem",
                f"status code: {status}",
                f"message: {messages.get(status, 'unknown failure')}",
            )
        return Solution(ivp, t[1:], np.asarray(ys), d_t=self._d_t)
