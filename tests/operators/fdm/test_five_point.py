"""Tests for the fourth-order five-point central difference method — a
capability beyond the reference (whose only concrete differentiator is
second-order, /root/reference/pararealml/operators/fdm/
numerical_differentiator.py:999-1242): interior fourth-order convergence,
boundary-closure equivalence with the three-point method, and end-to-end
FDM solves."""

import jax.numpy as jnp
import numpy as np
import pytest

from pararealml_tpu import (
    ConstrainedProblem,
    CoordinateSystem,
    DiffusionEquation,
    DirichletBoundaryCondition,
    GaussianInitialCondition,
    InitialValueProblem,
    Mesh,
    NeumannBoundaryCondition,
)
from pararealml_tpu.constrained_problem import BoundaryConstraintPair
from pararealml_tpu.constraint import Constraint
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    FivePointCentralDifferenceMethod,
    RK4,
    ThreePointCentralDifferenceMethod,
)

DIFF5 = FivePointCentralDifferenceMethod()
DIFF3 = ThreePointCentralDifferenceMethod()


def _interior(a, dims, width=2):
    sl = tuple([slice(width, -width)] * dims)
    return np.asarray(a)[sl]


def _cartesian_mesh(d_x, dims=1, extent=1.0):
    return Mesh([(0.0, extent)] * dims, [d_x] * dims)


# -- interior fourth-order convergence ---------------------------------------
# Halving the step of a fourth-order stencil must cut the interior error
# by ~2^4 = 16. The comparison region is the COARSE mesh's interior
# (every other fine vertex), so both errors are measured at the same
# physical points.


def _interior_order_ratio(op_error):
    coarse = op_error(0.02)
    fine = op_error(0.01)
    return coarse / fine


def test_first_derivative_interior_is_fourth_order():
    def error(d_x):
        mesh = _cartesian_mesh(d_x)
        x = mesh.vertex_coordinate_grids[0][..., None]
        y = jnp.sin(3.0 * x)
        derivative = DIFF5.gradient(y, mesh, 0)
        exact = 3.0 * jnp.cos(3.0 * x)
        n = y.shape[0]
        lo, hi = (n - 1) // 4, 3 * (n - 1) // 4
        return float(
            np.max(np.abs(np.asarray(derivative - exact)[lo:hi]))
        )

    ratio = _interior_order_ratio(error)
    assert 12.0 < ratio < 20.0


def test_second_derivative_interior_is_fourth_order():
    def error(d_x):
        mesh = _cartesian_mesh(d_x)
        x = mesh.vertex_coordinate_grids[0][..., None]
        y = jnp.sin(3.0 * x)
        second = DIFF5.hessian(y, mesh, 0, 0)
        exact = -9.0 * jnp.sin(3.0 * x)
        n = y.shape[0]
        lo, hi = (n - 1) // 4, 3 * (n - 1) // 4
        return float(np.max(np.abs(np.asarray(second - exact)[lo:hi])))

    ratio = _interior_order_ratio(error)
    assert 12.0 < ratio < 20.0


def test_polar_laplacian_interior_is_fourth_order():
    # the curvilinear metric terms are exact, so the interior order is
    # set by the stencils alone even off the Cartesian grid
    def error(d_x):
        mesh = Mesh(
            [(1.0, 2.0), (0.0, 1.0)],
            [d_x, d_x],
            CoordinateSystem.POLAR,
        )
        r_grid, theta_grid = mesh.vertex_coordinate_grids
        r = r_grid[..., None]
        theta = theta_grid[..., None]
        y = (r**2) * jnp.sin(2.0 * theta)
        laplacian = DIFF5.laplacian(y, mesh)
        # lap = y_rr + y_r / r + y_tt / r^2
        exact = (
            2.0 * jnp.sin(2.0 * theta)
            + 2.0 * jnp.sin(2.0 * theta)
            - 4.0 * (r**2) * jnp.sin(2.0 * theta) / r**2
        )
        n0, n1 = y.shape[0], y.shape[1]
        sl = (
            slice((n0 - 1) // 4, 3 * (n0 - 1) // 4),
            slice((n1 - 1) // 4, 3 * (n1 - 1) // 4),
        )
        return float(np.max(np.abs(np.asarray(laplacian - exact)[sl])))

    ratio = _interior_order_ratio(error)
    assert 12.0 < ratio < 20.0


def test_interior_error_beats_three_point():
    mesh = _cartesian_mesh(0.02)
    x = mesh.vertex_coordinate_grids[0][..., None]
    y = jnp.sin(3.0 * x)
    exact = 3.0 * jnp.cos(3.0 * x)
    n = y.shape[0]
    lo, hi = (n - 1) // 4, 3 * (n - 1) // 4

    def max_err(diff):
        return float(
            np.max(np.abs(np.asarray(diff.gradient(y, mesh, 0) - exact)[lo:hi]))
        )

    assert max_err(DIFF5) < 0.01 * max_err(DIFF3)


# -- boundary closure equals the three-point method's ------------------------


def test_boundary_slabs_match_three_point_first_derivative():
    mesh = _cartesian_mesh(0.05)
    x = mesh.vertex_coordinate_grids[0][..., None]
    y = jnp.exp(x)
    d5 = np.asarray(DIFF5.gradient(y, mesh, 0))
    d3 = np.asarray(DIFF3.gradient(y, mesh, 0))
    np.testing.assert_allclose(d5[:2], d3[:2])
    np.testing.assert_allclose(d5[-2:], d3[-2:])


def test_boundary_slabs_match_three_point_second_derivative():
    mesh = _cartesian_mesh(0.05)
    x = mesh.vertex_coordinate_grids[0][..., None]
    y = jnp.exp(x)
    values = jnp.full((1, 1), 2.5)
    mask = jnp.ones((1, 1), bool)
    pair = BoundaryConstraintPair(
        Constraint(values, mask), Constraint(values, mask)
    )
    d5 = np.asarray(DIFF5.hessian(y, mesh, 0, 0, [pair]))
    d3 = np.asarray(DIFF3.hessian(y, mesh, 0, 0, [pair]))
    # Neumann ghost synthesis at the faces is shared with the
    # three-point method, and the adjacent vertex uses the same
    # three-point formula
    np.testing.assert_allclose(d5[:2], d3[:2])
    np.testing.assert_allclose(d5[-2:], d3[-2:])


def test_derivative_constraint_override_applied_at_faces():
    mesh = _cartesian_mesh(0.1)
    x = mesh.vertex_coordinate_grids[0][..., None]
    y = x**2
    values = jnp.full((1, 1), 7.0)
    mask = jnp.ones((1, 1), bool)
    pair = BoundaryConstraintPair(
        Constraint(values, mask), Constraint(values, mask)
    )
    derivative = np.asarray(DIFF5.gradient(y, mesh, 0, [pair]))
    assert derivative[0, 0] == pytest.approx(7.0)
    assert derivative[-1, 0] == pytest.approx(7.0)


def test_minimum_point_count_validation():
    mesh = Mesh([(0.0, 1.0)], [0.25])
    y = jnp.zeros((5, 1))
    DIFF5.gradient(y, mesh, 0)  # 5 points is the minimum
    small_mesh = Mesh([(0.0, 1.0)], [1.0 / 3.0])
    with pytest.raises(ValueError, match="at least 5 points"):
        DIFF5.gradient(jnp.zeros((4, 1)), small_mesh, 0)
    with pytest.raises(ValueError, match="at least 5 points"):
        DIFF5.hessian(jnp.zeros((4, 1)), small_mesh, 0, 0)


# -- anti-Laplacian and end-to-end solves ------------------------------------


def test_anti_laplacian_inverts_laplacian():
    mesh = _cartesian_mesh(0.05, dims=2)
    grids = mesh.vertex_coordinate_grids
    x0, x1 = grids[0][..., None], grids[1][..., None]
    y = x0 * (1.0 - x0) * x1 * (1.0 - x1)
    y = jnp.asarray(y)
    mask = np.zeros(y.shape, bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    constraint = Constraint(jnp.zeros_like(y), jnp.asarray(mask))
    diff = FivePointCentralDifferenceMethod(tol=1e-8)
    laplacian = diff.laplacian(y, mesh)
    recovered = diff.anti_laplacian(laplacian, mesh, constraint)
    # the Jacobi sweep inverts the second-order operator, so recovery
    # of a fourth-order Laplacian is approximate at the discretization
    # error level
    assert float(jnp.max(jnp.abs(recovered - y))) < 5e-3


def _diffusion_ivp(d_x):
    diff_eq = DiffusionEquation(1, 0.5)
    mesh = Mesh([(0.0, 1.0)], [d_x])
    bcs = [
        (
            NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
            NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
    ]
    cp = ConstrainedProblem(diff_eq, mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.array([0.5]), np.array([[0.05]]))]
    )
    return InitialValueProblem(cp, (0.0, 0.1), ic)


def test_fdm_solve_with_five_point_matches_three_point():
    ivp = _diffusion_ivp(0.02)
    op5 = FDMOperator(RK4(), DIFF5, 1e-4)
    op3 = FDMOperator(RK4(), DIFF3, 1e-4)
    y5 = op5.solve(ivp).discrete_y()
    y3 = op3.solve(ivp).discrete_y()
    assert y5.shape == y3.shape
    # both discretizations approximate the same PDE; they agree to
    # truncation-error level on this resolution
    assert float(np.max(np.abs(y5 - y3))) < 1e-3


def test_fdm_solve_with_five_point_conserves_mass():
    # zero-flux Neumann diffusion conserves total (trapezoidal) mass.
    # The three-point stencil is discretely conservative under the
    # trapezoidal weights (the flux differences telescope exactly); the
    # five-point stencil is not summation-by-parts, so its defect is
    # nonzero but must stay at truncation level
    ivp = _diffusion_ivp(0.02)
    op5 = FDMOperator(RK4(), DIFF5, 1e-4)
    y = op5.solve(ivp).discrete_y()
    weights = np.ones(y.shape[1])
    weights[0] = weights[-1] = 0.5
    initial_mass = float(
        weights
        @ np.asarray(ivp.initial_condition.discrete_y_0(True))[:, 0]
    )
    final_mass = float(weights @ np.asarray(y[-1])[:, 0])
    assert final_mass == pytest.approx(initial_mass, rel=1e-3)


def test_dirichlet_solve_runs_on_generic_path():
    # a Dirichlet solve with the five-point differentiator runs end to
    # end, and its carry-only ends match the trajectory's last frame
    diff_eq = DiffusionEquation(2, 1.0)
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    bcs = [
        (
            DirichletBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
        * 2
    ] * 2
    cp = ConstrainedProblem(diff_eq, mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 0.5), 0.01 * np.eye(2))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.01), ic)
    op = FDMOperator(RK4(), DIFF5, 1e-4)
    ends_fn = op.ends_function(cp, (0.0, 0.01))
    solution = op.solve(ivp)
    assert solution.discrete_y().shape[0] == 100
    y_0 = np.asarray(ivp.initial_condition.discrete_y_0(True))
    np.testing.assert_allclose(
        np.asarray(ends_fn(y_0, 0.0)),
        solution.discrete_y()[-1],
        rtol=0.0,
        atol=1e-12,
    )
