"""Tests for the BiCGStab anti-Laplacian solver — a Krylov alternative
to the reference's Jacobi relaxation (/root/reference/pararealml/
operators/fdm/numerical_differentiator.py:872-927) solving the same
fixed-point equation with the same stopping criterion."""

import jax.numpy as jnp
import numpy as np
import pytest

from pararealml_tpu import (
    ConstrainedProblem,
    CoordinateSystem,
    DirichletBoundaryCondition,
    DiscreteInitialCondition,
    InitialValueProblem,
    Mesh,
    NavierStokesEquation,
)
from pararealml_tpu.constrained_problem import BoundaryConstraintPair
from pararealml_tpu.constraint import Constraint
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    FivePointCentralDifferenceMethod,
    RK4,
    ThreePointCentralDifferenceMethod,
)


def _dirichlet_boundary_constraint(shape):
    mask = np.zeros(shape, bool)
    for axis in range(len(shape) - 1):
        index_lo = [slice(None)] * len(shape)
        index_lo[axis] = 0
        index_hi = [slice(None)] * len(shape)
        index_hi[axis] = -1
        mask[tuple(index_lo)] = True
        mask[tuple(index_hi)] = True
    return Constraint(jnp.zeros(shape), jnp.asarray(mask))


def test_invalid_method_name_rejected():
    with pytest.raises(ValueError, match="anti-Laplacian method"):
        ThreePointCentralDifferenceMethod(anti_laplacian_method="sor")


def test_method_property():
    diff = ThreePointCentralDifferenceMethod(
        anti_laplacian_method="bicgstab"
    )
    assert diff.anti_laplacian_method == "bicgstab"
    assert (
        ThreePointCentralDifferenceMethod().anti_laplacian_method
        == "jacobi"
    )


def test_matches_jacobi_cartesian():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.05, 0.05])
    grids = mesh.vertex_coordinate_grids
    x0, x1 = grids[0][..., None], grids[1][..., None]
    y = jnp.asarray(np.sin(np.pi * x0) * np.sin(np.pi * x1))
    constraint = _dirichlet_boundary_constraint(y.shape)

    jacobi = ThreePointCentralDifferenceMethod(tol=1e-10)
    krylov = ThreePointCentralDifferenceMethod(
        tol=1e-10, anti_laplacian_method="bicgstab"
    )
    laplacian = jacobi.laplacian(y, mesh)
    y_jacobi = jacobi.anti_laplacian(laplacian, mesh, constraint)
    y_krylov = krylov.anti_laplacian(laplacian, mesh, constraint)
    assert float(jnp.max(jnp.abs(y_krylov - y_jacobi))) < 1e-7
    # both recover the constrained field
    assert float(jnp.max(jnp.abs(y_krylov - y))) < 1e-4


def test_matches_jacobi_polar():
    mesh = Mesh(
        [(1.0, 2.0), (0.0, np.pi)],
        [0.05, np.pi / 20.0],
        CoordinateSystem.POLAR,
    )
    r_grid, theta_grid = mesh.vertex_coordinate_grids
    r = r_grid[..., None]
    theta = theta_grid[..., None]
    y = jnp.asarray((r - 1.0) * (2.0 - r) * np.sin(theta))
    constraint = _dirichlet_boundary_constraint(y.shape)

    jacobi = ThreePointCentralDifferenceMethod(tol=1e-10)
    krylov = ThreePointCentralDifferenceMethod(
        tol=1e-10, anti_laplacian_method="bicgstab"
    )
    laplacian = jacobi.laplacian(y, mesh)
    y_jacobi = jacobi.anti_laplacian(laplacian, mesh, constraint)
    y_krylov = krylov.anti_laplacian(laplacian, mesh, constraint)
    assert float(jnp.max(jnp.abs(y_krylov - y_jacobi))) < 1e-7


def test_matches_jacobi_with_neumann_halos():
    # a derivative boundary constraint on one axis exercises the
    # affine (ghost-synthesis) part of the sweep that BiCGStab must
    # fold into the right-hand side
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.05, 0.05])
    grids = mesh.vertex_coordinate_grids
    x0, x1 = grids[0][..., None], grids[1][..., None]
    y = jnp.asarray(np.cos(np.pi * x0) * np.sin(np.pi * x1))

    # Dirichlet on axis 1 faces only; zero normal derivative on axis 0
    shape = y.shape
    mask = np.zeros(shape, bool)
    mask[:, 0] = mask[:, -1] = True
    constraint = Constraint(jnp.zeros(shape), jnp.asarray(mask))
    face_shape = (1,) + shape[1:]
    neumann_pair = BoundaryConstraintPair(
        Constraint(jnp.zeros(face_shape), jnp.ones(face_shape, bool)),
        Constraint(jnp.zeros(face_shape), jnp.ones(face_shape, bool)),
    )
    derivative_bcs = [neumann_pair, None]

    jacobi = ThreePointCentralDifferenceMethod(tol=1e-10)
    krylov = ThreePointCentralDifferenceMethod(
        tol=1e-10, anti_laplacian_method="bicgstab"
    )
    laplacian = jacobi.laplacian(y, mesh, derivative_bcs)
    y_jacobi = jacobi.anti_laplacian(
        laplacian, mesh, constraint, derivative_bcs
    )
    y_krylov = krylov.anti_laplacian(
        laplacian, mesh, constraint, derivative_bcs
    )
    assert float(jnp.max(jnp.abs(y_krylov - y_jacobi))) < 1e-7


def test_works_with_five_point_differentiator():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    grids = mesh.vertex_coordinate_grids
    x0, x1 = grids[0][..., None], grids[1][..., None]
    y = jnp.asarray(np.sin(np.pi * x0) * np.sin(np.pi * x1))
    constraint = _dirichlet_boundary_constraint(y.shape)
    krylov = FivePointCentralDifferenceMethod(
        tol=1e-10, anti_laplacian_method="bicgstab"
    )
    jacobi = FivePointCentralDifferenceMethod(tol=1e-10)
    laplacian = krylov.laplacian(y, mesh)
    recovered = krylov.anti_laplacian(laplacian, mesh, constraint)
    recovered_jacobi = jacobi.anti_laplacian(laplacian, mesh, constraint)
    assert (
        float(jnp.max(jnp.abs(recovered - recovered_jacobi))) < 1e-7
    )
    # recovery of the FOURTH-order Laplacian through the second-order
    # inversion operator is approximate at discretization-mismatch level
    assert float(jnp.max(jnp.abs(recovered - y))) < 2e-2


def _navier_stokes_ivp():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.tile(
            np.array([[np.nan, 0.0, np.nan, np.nan]]), (len(x), 1)
        ),
        is_static=True,
    )
    cp = ConstrainedProblem(
        NavierStokesEquation(1000.0), mesh, [(bc, bc)] * 2
    )
    rng = np.random.default_rng(1)
    y_0 = np.zeros(cp.y_shape(True))
    y_0[..., 0] = rng.uniform(-1.0, 1.0, y_0.shape[:-1])
    ic = DiscreteInitialCondition(cp, y_0, True)
    return InitialValueProblem(cp, (0.0, 0.05), ic), cp


def test_navier_stokes_solve_matches_jacobi():
    ivp, cp = _navier_stokes_ivp()
    jacobi_op = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(tol=1e-8), 0.01
    )
    krylov_op = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(
            tol=1e-8, anti_laplacian_method="bicgstab"
        ),
        0.01,
    )
    y_jacobi = jacobi_op.solve(ivp).discrete_y()
    y_krylov = krylov_op.solve(ivp).discrete_y()
    assert np.all(np.isfinite(y_krylov))
    # both solves drive the stream-function residual to 1e-8; the
    # trajectories agree to solver-tolerance level
    assert float(np.max(np.abs(y_krylov - y_jacobi))) < 1e-5


def test_navier_stokes_bicgstab_stays_off_fused_kernel(monkeypatch):
    # the solver's step must run the anti-Laplacian method the
    # differentiator was configured with
    import jax
    import jax.numpy as jnp

    ivp, cp = _navier_stokes_ivp()
    differentiator = ThreePointCentralDifferenceMethod(
        tol=1e-8, anti_laplacian_method="bicgstab"
    )
    calls = []
    method = type(differentiator)._anti_laplacian_bicgstab

    def spy(self, *args, **kwargs):
        calls.append(1)
        return method(self, *args, **kwargs)

    monkeypatch.setattr(
        type(differentiator), "_anti_laplacian_bicgstab", spy
    )
    op = FDMOperator(RK4(), differentiator, 0.01)
    fn, _ = op.trajectory_function(cp, (0.0, 0.02))
    y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))
    jax.eval_shape(fn, y_0, 0.0)
    assert calls
