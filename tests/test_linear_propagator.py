"""Tests for the affine (linear) propagator formulation — the
matmul path Parareal sub-solves use on linear problems
(:mod:`pararealml_tpu.ops.linear_propagator`).

The reference has no counterpart (its fine solves are always
time-stepped, /root/reference/pararealml/operators/parareal/
parareal_operator.py:163); these tests pin the formulation's exactness
against the stencil steppers, its applicability predicates, and its
tolerance gating inside :class:`PararealOperator`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pararealml_tpu import (
    BurgersEquation,
    ConstrainedProblem,
    DiffusionEquation,
    DirichletBoundaryCondition,
    GaussianInitialCondition,
    InitialValueProblem,
    LotkaVolterraEquation,
    Mesh,
    NeumannBoundaryCondition,
    WaveEquation,
)
from pararealml_tpu.operators.fdm import (
    CrankNicolsonMethod,
    FDMOperator,
    RK4,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu.operators.parareal import PararealOperator
from pararealml_tpu.ops.linear_propagator import (
    build_linear_propagator_trajectory,
    equation_system_is_affine,
    linear_propagator_applicable,
    probe_affine_step,
)


def _diffusion_cp(d_x=0.5):
    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [d_x, d_x])
    bcs = [
        (
            DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 1.5), is_static=True
            ),
        )
        * 2,
        (
            NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
        * 2,
    ]
    return ConstrainedProblem(DiffusionEquation(2, 0.25), mesh, bcs)


def _gaussian_y0(cp):
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 2.5), np.eye(2))], [20.0]
    )
    return jnp.asarray(ic.discrete_y_0(True))


def test_affinity_detection():
    assert equation_system_is_affine(DiffusionEquation(2, 0.5))
    assert equation_system_is_affine(WaveEquation(2))
    assert not equation_system_is_affine(BurgersEquation(2))
    assert not equation_system_is_affine(
        LotkaVolterraEquation(2.0, 0.04, 1.06, 0.02)
    )


def test_applicability_predicate():
    cp = _diffusion_cp()
    assert linear_propagator_applicable(cp, RK4())
    # implicit integrators solve a fixed-point iteration with a
    # data-dependent exit — not probe-recoverable as one affine map
    assert not linear_propagator_applicable(cp, CrankNicolsonMethod())
    # nonlinear equations are rejected
    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [0.5, 0.5])
    bcs = [
        (
            NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 2)), is_static=True
            ),
        )
        * 2
    ] * 2
    burgers_cp = ConstrainedProblem(
        BurgersEquation(2, 100.0), mesh, bcs
    )
    assert not linear_propagator_applicable(burgers_cp, RK4())
    # dynamic boundary conditions are rejected
    dyn_bcs = [
        (
            DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), t), is_static=False
            ),
        )
        * 2
    ] * 2
    dyn_cp = ConstrainedProblem(
        DiffusionEquation(2, 0.25), mesh, dyn_bcs
    )
    assert not linear_propagator_applicable(dyn_cp, RK4())
    # dimension cap
    assert not linear_propagator_applicable(cp, RK4(), max_dim=10)


def test_probe_recovers_manual_affine_map():
    rng = np.random.default_rng(7)
    y_shape = (3, 4)
    dim = int(np.prod(y_shape))
    a = jnp.asarray(0.1 * rng.standard_normal((dim, dim)))
    b = jnp.asarray(rng.standard_normal(dim))

    def step_fn(y, i, t):
        return (a @ y.reshape(dim) + b).reshape(y_shape)

    s, q = probe_affine_step(step_fn, y_shape)
    np.testing.assert_allclose(np.asarray(s), np.asarray(a), atol=1e-12)
    np.testing.assert_allclose(np.asarray(q), np.asarray(b), atol=1e-12)


def test_probe_rejects_nonlinear_step():
    y_shape = (4,)

    def step_fn(y, i, t):
        return y + 0.5 * y**2

    with pytest.raises(ValueError, match="not affine"):
        probe_affine_step(step_fn, y_shape)


def test_trajectory_and_end_function_match_stepping():
    rng = np.random.default_rng(3)
    y_shape = (2, 3)
    dim = int(np.prod(y_shape))
    a = jnp.asarray(np.eye(dim) + 0.05 * rng.standard_normal((dim, dim)))
    b = jnp.asarray(0.1 * rng.standard_normal(dim))

    def step_fn(y, i, t):
        return (a @ y.reshape(dim) + b).reshape(y_shape)

    cp = _diffusion_cp()  # only consulted for docstring symmetry
    # 11 = 1011b exercises multiple set bits in the end-state binary
    # power chain
    n_steps = 11
    trajectory = build_linear_propagator_trajectory(
        cp, step_fn, n_steps, y_shape
    )
    y_0 = jnp.asarray(rng.standard_normal(y_shape))
    expected = []
    y = y_0
    for _ in range(n_steps):
        y = step_fn(y, 0, 0.0)
        expected.append(np.asarray(y))
    actual = np.asarray(trajectory(y_0))
    np.testing.assert_allclose(actual, np.stack(expected), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(trajectory.end_function(y_0)),
        expected[-1],
        atol=1e-9,
    )
    batched = np.asarray(
        jax.vmap(trajectory)(jnp.stack([y_0, 2.0 * y_0]))
    )
    np.testing.assert_allclose(batched[0], actual, atol=1e-9)

    # the materialized slice map (P, r) must reproduce the composed
    # n_steps-step affine map (it feeds Parareal's doubling-scan
    # coarse sweeps)
    pt, r = trajectory.affine_slice_map
    via_map = np.asarray(
        jnp.matmul(
            jnp.asarray(y_0).reshape(dim),
            pt,
            precision=jax.lax.Precision.HIGHEST,
        )
        + r
    ).reshape(y_shape)
    np.testing.assert_allclose(via_map, expected[-1], atol=1e-9)


def test_fdm_time_parallel_trajectory_matches_generic():
    cp = _diffusion_cp()
    y_0 = _gaussian_y0(cp)
    op = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.01
    )
    generic_fn, t = op.trajectory_function(cp, (0.0, 0.5))
    prop_fn, t_p = op.trajectory_function(
        cp, (0.0, 0.5), time_parallel=True
    )
    assert prop_fn is not generic_fn
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_p))
    expected = np.asarray(generic_fn(y_0, jnp.asarray(0.0)))
    actual = np.asarray(prop_fn(y_0, jnp.asarray(0.0)))
    # under the x64 test configuration both paths run in f64, so the
    # only difference is matmul-vs-stencil accumulation order
    np.testing.assert_allclose(actual, expected, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(prop_fn.end_function(y_0, jnp.asarray(0.0))),
        expected[-1],
        atol=1e-8,
    )


def test_fdm_linear_propagator_opt_out():
    cp = _diffusion_cp()
    op = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.01,
        linear_propagator=False,
    )
    fn, _ = op.trajectory_function(cp, (0.0, 0.1), time_parallel=True)
    assert not hasattr(fn, "end_function")


def test_parareal_tolerance_gating():
    cp = _diffusion_cp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.025)
    # tolerances above the floor sanction the propagator fast path
    assert PararealOperator(
        f, g, 1e-3, num_time_slices=4
    )._use_time_parallel_trajectories(cp)
    # iterate-to-exactness (and sub-floor) tolerances keep
    # bitwise-stencil fine solves
    assert not PararealOperator(
        f, g, 0.0, num_time_slices=4
    )._use_time_parallel_trajectories(cp)
    assert not PararealOperator(
        f, g, 1e-8, num_time_slices=4
    )._use_time_parallel_trajectories(cp)
    # any sub-floor component of a vector tolerance disables the path
    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [0.5, 0.5])
    wave_cp = ConstrainedProblem(
        WaveEquation(2),
        mesh,
        [
            (
                DirichletBoundaryCondition(
                    lambda x, t: np.zeros((len(x), 2)), is_static=True
                ),
            )
            * 2
        ]
        * 2,
    )
    assert PararealOperator(
        f, g, [1e-3, 1e-3], num_time_slices=4
    )._use_time_parallel_trajectories(wave_cp)
    assert not PararealOperator(
        f, g, [1e-3, 1e-8], num_time_slices=4
    )._use_time_parallel_trajectories(wave_cp)


def test_parareal_propagator_solve_matches_fine():
    cp = _diffusion_cp()
    ivp = InitialValueProblem(
        cp,
        (0.0, 2.0),
        GaussianInitialCondition(
            cp, [(np.full(2, 2.5), np.eye(2))], [20.0]
        ),
    )
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.025)
    tolerance = 1e-3
    parareal = PararealOperator(f, g, tolerance, num_time_slices=8)
    assert parareal._use_time_parallel_trajectories(cp)
    solution = parareal.solve(ivp)
    fine = f.solve(ivp)
    np.testing.assert_allclose(
        solution.discrete_y(solution.vertex_oriented),
        fine.discrete_y(fine.vertex_oriented),
        atol=5 * tolerance,
    )


def test_parareal_tolerance_gating_is_scale_aware():
    # the rounding floor is ~relative to the state magnitude while the
    # termination tolerance is absolute: a large-amplitude initial
    # state must disable the propagator path for tolerances the f32
    # matmul formulation cannot reach in absolute terms
    cp = _diffusion_cp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.025)
    parareal = PararealOperator(f, g, 1e-3, num_time_slices=4)
    small_state = np.ones(cp.y_shape(True))
    large_state = np.full(cp.y_shape(True), 1e6)
    assert parareal._use_time_parallel_trajectories(cp, small_state)
    assert not parareal._use_time_parallel_trajectories(cp, large_state)
    # without a state the absolute floor applies (backward compatible)
    assert parareal._use_time_parallel_trajectories(cp)


def test_deep_trajectory_doubling_expansion_matches_stepping():
    # enough steps that n_chunks >= 16: the chunk-boundary doubling
    # scan (log-depth expansion) must reproduce sequential stepping
    rng = np.random.default_rng(7)
    y_shape = (2, 3)
    dim = int(np.prod(y_shape))
    a_np = np.eye(dim) + 0.01 * rng.standard_normal((dim, dim))
    b_np = 0.01 * rng.standard_normal(dim)
    a, b = jnp.asarray(a_np), jnp.asarray(b_np)

    def step_fn(y, i, t):
        return (a @ y.reshape(dim) + b).reshape(y_shape)

    cp = _diffusion_cp()
    n_steps = 1039  # prime: no divisor chunk, padded tail exercised
    trajectory = build_linear_propagator_trajectory(
        cp, step_fn, n_steps, y_shape
    )
    y_0 = rng.standard_normal(y_shape)

    expected = []
    y = y_0.reshape(dim)
    for _ in range(n_steps):
        y = a_np @ y + b_np
        expected.append(y.reshape(y_shape))
    expected = np.stack(expected)

    actual = np.asarray(jax.jit(trajectory)(jnp.asarray(y_0), 0.0))
    np.testing.assert_allclose(actual, expected, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(trajectory.end_function(jnp.asarray(y_0))),
        expected[-1],
        atol=1e-8,
    )
