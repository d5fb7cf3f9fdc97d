"""Spatial domain decomposition (``FDMOperator(spatial_mesh=...)``).

Every test solves the same problem twice — on one device and decomposed
over the 8-device test mesh — and requires the decomposed trajectory to
match at every real vertex. The reference has no spatial scaling at all
(its parallelism is time-only MPI,
/root/reference/pararealml/operators/parareal/parareal_operator.py:102-197),
so these tests pin the feature against this framework's own
single-device solves instead.
"""

import numpy as np
import pytest
from jax.sharding import PartitionSpec

from pararealml_tpu import (
    BurgersEquation,
    CahnHilliardEquation,
    ConstrainedProblem,
    ContinuousInitialCondition,
    CoordinateSystem,
    DiffusionEquation,
    DirichletBoundaryCondition,
    DiscreteInitialCondition,
    GaussianInitialCondition,
    InitialValueProblem,
    LorenzEquation,
    Mesh,
    NavierStokesEquation,
    NeumannBoundaryCondition,
    WaveEquation,
)
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    RK4,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu.utils.distributed import space_mesh


def _zero_neumann(y_dim):
    return NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), y_dim)), is_static=True
    )


def _solve_both(ivp, d_t, mesh=None, partition=None, tol=1e-3):
    single = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(tol=tol),
        d_t,
    )
    sharded = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(tol=tol),
        d_t,
        spatial_mesh=mesh if mesh is not None else space_mesh(8),
        spatial_partition=partition,
    )
    return (
        single.solve(ivp).discrete_y(),
        sharded.solve(ivp).discrete_y(),
    )


def test_diffusion_2d_uneven_grid_matches_single_device():
    diff_eq = DiffusionEquation(2, 0.25)
    mesh = Mesh([(0.0, 4.0), (0.0, 4.0)], (0.2, 0.2))  # 21x21 over 8
    bcs = (
        (
            DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 1.0), is_static=True
            ),
            _zero_neumann(1),
        ),
    ) * 2
    cp = ConstrainedProblem(diff_eq, mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 2.0), np.eye(2))], [10.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.2), ic)

    expected, actual = _solve_both(ivp, 0.01)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_diffusion_2d_divisible_grid_skips_padding():
    diff_eq = DiffusionEquation(2, 0.25)
    mesh = Mesh([(0.0, 1.5), (0.0, 1.5)], (0.1, 0.1))  # 16x16 over 8
    cp = ConstrainedProblem(diff_eq, mesh, [(_zero_neumann(1),) * 2] * 2)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 0.75), 0.1 * np.eye(2))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_diffusion_1d_sharded():
    diff_eq = DiffusionEquation(1, 0.5)
    mesh = Mesh([(0.0, 10.0)], [0.25])  # 41 vertices over 8
    cp = ConstrainedProblem(diff_eq, mesh, [(_zero_neumann(1),) * 2])
    ic = GaussianInitialCondition(
        cp, [(np.array([5.0]), np.array([[2.0]]))], [20.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_dynamic_boundary_conditions_sharded():
    mesh = Mesh([(0.0, 1.0)], [0.05])  # 21 vertices over 8
    bc = DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), 1), np.sin(t))
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.1), mesh, [(bc, bc)])
    ic = ContinuousInitialCondition(cp, lambda x: np.zeros_like(x))
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)

    expected, actual = _solve_both(ivp, 0.05)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)
    # the decomposed solve must still track the dynamic boundary value
    t = np.linspace(0.05, 0.5, 10)
    np.testing.assert_allclose(actual[:, 0, 0], np.sin(t), atol=1e-12)


def test_wave_system_sharded():
    mesh = Mesh([(0.0, 2.0), (0.0, 2.0)], [0.2, 0.2])  # 11x11
    cp = ConstrainedProblem(
        WaveEquation(2), mesh, [(_zero_neumann(2),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 1.0), 0.1 * np.eye(2))] * 2, [1.0, 0.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.2), ic)

    expected, actual = _solve_both(ivp, 0.02)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_burgers_nonlinear_system_sharded():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])  # 11x11
    cp = ConstrainedProblem(
        BurgersEquation(2, 100.0), mesh, [(_zero_neumann(2),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 0.5), 0.1 * np.eye(2))] * 2
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_cahn_hilliard_nested_derivatives_sharded():
    # nabla^2(c^3 - c - gamma nabla^2 c): nested stencils exercise the
    # padded boundary handling through composed derivative expressions
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    cp = ConstrainedProblem(
        CahnHilliardEquation(2), mesh, [(_zero_neumann(2),) * 2] * 2
    )
    rng = np.random.default_rng(0)
    y_0 = 0.05 * rng.uniform(-1.0, 1.0, cp.y_shape(True))
    ic = DiscreteInitialCondition(cp, y_0, True)
    ivp = InitialValueProblem(cp, (0.0, 0.05), ic)

    expected, actual = _solve_both(ivp, 0.005)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_navier_stokes_anti_laplacian_sharded():
    # the stream-function solve runs the Jacobi while_loop under the
    # SPMD partitioner with a sharded convergence norm
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.tile(
            np.array([[np.nan, 0.0, np.nan, np.nan]]), (len(x), 1)
        ),
        is_static=True,
    )
    cp = ConstrainedProblem(NavierStokesEquation(1000.0), mesh, [(bc, bc)] * 2)
    rng = np.random.default_rng(1)
    y_0 = np.zeros(cp.y_shape(True))
    y_0[..., 0] = rng.uniform(-1.0, 1.0, y_0.shape[:-1])
    ic = DiscreteInitialCondition(cp, y_0, True)
    ivp = InitialValueProblem(cp, (0.0, 0.02), ic)

    expected, actual = _solve_both(ivp, 0.01, tol=1e-6)
    assert np.all(np.isfinite(actual))
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-9)


def test_navier_stokes_bicgstab_anti_laplacian_sharded():
    # the Krylov stream-function solve (matvec stencils + global dot
    # products) must also decompose under the SPMD partitioner and
    # match the single-device solve
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.tile(
            np.array([[np.nan, 0.0, np.nan, np.nan]]), (len(x), 1)
        ),
        is_static=True,
    )
    cp = ConstrainedProblem(NavierStokesEquation(1000.0), mesh, [(bc, bc)] * 2)
    rng = np.random.default_rng(1)
    y_0 = np.zeros(cp.y_shape(True))
    y_0[..., 0] = rng.uniform(-1.0, 1.0, y_0.shape[:-1])
    ic = DiscreteInitialCondition(cp, y_0, True)
    ivp = InitialValueProblem(cp, (0.0, 0.02), ic)

    differentiator = ThreePointCentralDifferenceMethod(
        tol=1e-8, anti_laplacian_method="bicgstab"
    )
    single = FDMOperator(RK4(), differentiator, 0.01)
    sharded = FDMOperator(
        RK4(), differentiator, 0.01, spatial_mesh=space_mesh(8)
    )
    expected = single.solve(ivp).discrete_y()
    actual = sharded.solve(ivp).discrete_y()
    assert np.all(np.isfinite(actual))
    # unlike Jacobi (whose norm only gates the iteration count), the
    # BiCGStab iterate path depends on dot products, whose sharded
    # reductions reassociate — agreement is at tolerance level, not
    # bit-exact
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-6)


def test_polar_diffusion_sharded():
    mesh = Mesh(
        [(1.0, 5.0), (0.0, 2.0 * np.pi)],
        [0.25, np.pi / 8.0],  # 17x17
        CoordinateSystem.POLAR,
    )
    cp = ConstrainedProblem(
        DiffusionEquation(2), mesh, [(_zero_neumann(1),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.array([3.0, np.pi]), np.eye(2))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_two_axis_partition():
    diff_eq = DiffusionEquation(2, 0.25)
    mesh = Mesh([(0.0, 4.0), (0.0, 4.0)], (0.2, 0.2))
    cp = ConstrainedProblem(diff_eq, mesh, [(_zero_neumann(1),) * 2] * 2)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 2.0), np.eye(2))], [10.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(
        ivp,
        0.01,
        mesh=space_mesh(8, shape=(4, 2), axis_names=("sx", "sy")),
        partition=PartitionSpec("sx", "sy"),
    )
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_coordinate_dependent_source_sharded():
    # an RHS referencing the coordinate symbols drives the padded
    # (edge-extended) coordinate grids through the symbol mapper
    from pararealml_tpu import SymbolicEquationSystem
    from pararealml_tpu.differential_equation import DifferentialEquation

    class SpatialSourceDiffusionEquation(DifferentialEquation):
        def __init__(self):
            super().__init__(2, 1)

        @property
        def symbolic_equation_system(self):
            return SymbolicEquationSystem(
                [
                    0.1 * self._symbols.y_laplacian[0]
                    + self._symbols.x[0]
                    - 0.5 * self._symbols.x[1]
                ]
            )

    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    cp = ConstrainedProblem(
        SpatialSourceDiffusionEquation(),
        mesh,
        [(_zero_neumann(1),) * 2] * 2,
    )
    ic = ContinuousInitialCondition(
        cp, lambda x: np.zeros((len(x), 1))
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_diffusion_3d_sharded():
    diff_eq = DiffusionEquation(3, 0.25)
    mesh = Mesh([(0.0, 1.0)] * 3, [0.2] * 3)  # 6x6x6 over 8
    cp = ConstrainedProblem(diff_eq, mesh, [(_zero_neumann(1),) * 2] * 3)
    ic = GaussianInitialCondition(
        cp, [(np.full(3, 0.5), 0.1 * np.eye(3))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_ode_problem_rejects_spatial_mesh():
    cp = ConstrainedProblem(LorenzEquation())
    ic = ContinuousInitialCondition(cp, lambda _: np.ones(3))
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.01,
        spatial_mesh=space_mesh(8),
    )
    with pytest.raises(ValueError, match="requires a PDE"):
        op.solve(ivp)


def test_partition_wider_than_grid_rejected():
    mesh = Mesh([(0.0, 1.0)], [0.1])
    cp = ConstrainedProblem(
        DiffusionEquation(1), mesh, [(_zero_neumann(1),) * 2]
    )
    ic = ContinuousInitialCondition(cp, lambda x: np.zeros_like(x))
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.01,
        spatial_mesh=space_mesh(8, shape=(4, 2), axis_names=("sx", "sy")),
        spatial_partition=PartitionSpec("sx", "sy"),
    )
    with pytest.raises(ValueError, match="more axes"):
        op.solve(ivp)


def test_cylindrical_diffusion_sharded():
    mesh = Mesh(
        [(1.0, 3.0), (0.0, 2.0 * np.pi), (0.0, 2.0)],
        [0.25, np.pi / 4.0, 0.25],  # 9x9x9
        CoordinateSystem.CYLINDRICAL,
    )
    cp = ConstrainedProblem(
        DiffusionEquation(3), mesh, [(_zero_neumann(1),) * 2] * 3
    )
    ic = GaussianInitialCondition(
        cp, [(np.array([2.0, np.pi, 1.0]), np.eye(3))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.05), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_spherical_diffusion_sharded():
    mesh = Mesh(
        [(1.0, 3.0), (0.0, 2.0 * np.pi), (0.1 * np.pi, 0.9 * np.pi)],
        [0.25, np.pi / 4.0, 0.1 * np.pi],  # 9x9x9
        CoordinateSystem.SPHERICAL,
    )
    cp = ConstrainedProblem(
        DiffusionEquation(3), mesh, [(_zero_neumann(1),) * 2] * 3
    )
    ic = GaussianInitialCondition(
        cp, [(np.array([2.0, np.pi, 0.5 * np.pi]), np.eye(3))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.05), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_shallow_water_three_component_sharded():
    from pararealml_tpu import ShallowWaterEquation

    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [0.5, 0.5])  # 11x11
    cp = ConstrainedProblem(
        ShallowWaterEquation(0.5), mesh, [(_zero_neumann(3),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp,
        [(np.full(2, 2.5), 0.25 * np.eye(2))] * 3,
        [1.0, 0.0, 0.0],
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)

    expected, actual = _solve_both(ivp, 0.01)
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)


def test_implicit_integrator_sharded():
    # Crank-Nicolson's element-wise secant while_loop under the SPMD
    # partitioner
    from pararealml_tpu.operators.fdm import CrankNicolsonMethod

    diff_eq = DiffusionEquation(1, 0.5)
    mesh = Mesh([(0.0, 10.0)], [0.25])  # 41 vertices over 8
    cp = ConstrainedProblem(diff_eq, mesh, [(_zero_neumann(1),) * 2])
    ic = GaussianInitialCondition(
        cp, [(np.array([5.0]), np.array([[2.0]]))], [20.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)

    single = FDMOperator(
        CrankNicolsonMethod(),
        ThreePointCentralDifferenceMethod(),
        0.05,
    )
    sharded = FDMOperator(
        CrankNicolsonMethod(),
        ThreePointCentralDifferenceMethod(),
        0.05,
        spatial_mesh=space_mesh(8),
    )
    expected = single.solve(ivp).discrete_y()
    actual = sharded.solve(ivp).discrete_y()
    np.testing.assert_allclose(actual, expected, rtol=0, atol=1e-12)
