import numpy as np
import pytest

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
    PopulationGrowthEquation,
    ShallowWaterEquation,
    WaveEquation,
)
from pararealml_tpu.operators.fdm import (
    BackwardEulerMethod,
    CrankNicolsonMethod,
    FDMOperator,
    ForwardEulerMethod,
    RK4,
    ThreePointCentralDifferenceMethod,
)


def _zero_neumann(y_dim):
    return NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), y_dim)), is_static=True
    )


def test_ode_with_analytic_solution():
    r, y_0 = 0.02, 100.0
    cp = ConstrainedProblem(PopulationGrowthEquation(r))
    ic = ContinuousInitialCondition(cp, lambda _: np.array([y_0]))
    ivp = InitialValueProblem(
        cp,
        (0.0, 10.0),
        ic,
        lambda _ivp, t, x: np.array([y_0 * np.exp(r * t)]),
    )

    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 1e-3)
    solution = op.solve(ivp)
    assert solution.d_t == 1e-3
    assert solution.discrete_y().shape == (10_000, 1)

    analytic = np.stack(
        [ivp.exact_y(t) for t in solution.t_coordinates]
    )
    assert np.allclose(analytic, solution.discrete_y())


def test_conserves_density_on_zero_flux_diffusion():
    diff_eq = DiffusionEquation(1, 5.0)
    mesh = Mesh([(0.0, 100.0)], [0.5])
    cp = ConstrainedProblem(diff_eq, mesh, [(_zero_neumann(1),) * 2])
    ic = GaussianInitialCondition(
        cp, [(np.array([50.0]), np.array([[50.0]]))], [100.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 5.0), ic)

    op = FDMOperator(
        CrankNicolsonMethod(), ThreePointCentralDifferenceMethod(), 1e-2
    )
    y = op.solve(ivp).discrete_y()
    y_sums = y.sum(axis=(1, 2))
    assert np.allclose(y_sums, ic.discrete_y_0(True).sum(), rtol=1e-4)


def test_lorenz_ode():
    cp = ConstrainedProblem(LorenzEquation())
    ic = ContinuousInitialCondition(cp, lambda _: np.ones(3))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    op = FDMOperator(
        ForwardEulerMethod(), ThreePointCentralDifferenceMethod(), 1e-3
    )
    solution = op.solve(ivp)
    assert solution.discrete_y().shape == (1000, 3)


def test_2d_diffusion_matches_1d_profile():
    # a y-invariant initial profile on a 2D mesh must evolve exactly like
    # the corresponding 1D problem
    d_t = 0.01
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), d_t)

    mesh_1d = Mesh([(0.0, 1.0)], [0.1])
    cp_1d = ConstrainedProblem(
        DiffusionEquation(1, 0.5), mesh_1d, [(_zero_neumann(1),) * 2]
    )
    x = mesh_1d.vertex_axis_coordinates[0]
    profile = np.cos(np.pi * x)
    ic_1d = DiscreteInitialCondition(
        cp_1d, profile.reshape(-1, 1), True
    )
    y_1d = op.solve(
        InitialValueProblem(cp_1d, (0.0, 0.5), ic_1d)
    ).discrete_y()

    mesh_2d = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    cp_2d = ConstrainedProblem(
        DiffusionEquation(2, 0.5), mesh_2d, [(_zero_neumann(1),) * 2] * 2
    )
    ic_2d = DiscreteInitialCondition(
        cp_2d,
        np.tile(profile.reshape(-1, 1, 1), (1, 11, 1)),
        True,
    )
    y_2d = op.solve(
        InitialValueProblem(cp_2d, (0.0, 0.5), ic_2d)
    ).discrete_y()

    for j in range(11):
        assert np.allclose(y_2d[:, :, j, 0], y_1d[:, :, 0], atol=1e-10)


def test_1d_diffusion_dirichlet_steady_state():
    mesh = Mesh([(0.0, 1.0)], [0.05])
    bc_pair = (
        DirichletBoundaryCondition(
            lambda x, t: np.zeros((len(x), 1)), is_static=True
        ),
        DirichletBoundaryCondition(
            lambda x, t: np.ones((len(x), 1)), is_static=True
        ),
    )
    cp = ConstrainedProblem(DiffusionEquation(1), mesh, [bc_pair])
    ic = ContinuousInitialCondition(cp, lambda x: np.zeros_like(x))
    ivp = InitialValueProblem(cp, (0.0, 2.0), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 5e-4)
    y = op.solve(ivp).discrete_y()
    assert np.allclose(
        y[-1, :, 0], mesh.vertex_axis_coordinates[0], atol=1e-6
    )


def test_wave_equation():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1])
    cp = ConstrainedProblem(
        WaveEquation(2), mesh, [(_zero_neumann(2),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp,
        [(np.full(2, 0.5), 0.05 * np.eye(2))] * 2,
        [1.0, 0.0],
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    solution = op.solve(ivp)
    assert solution.discrete_y().shape == (10, 11, 11, 2)


def test_burgers_equation():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.25, 0.25])
    cp = ConstrainedProblem(
        BurgersEquation(2, 100.0), mesh, [(_zero_neumann(2),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 0.5), 0.1 * np.eye(2))] * 2
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    assert op.solve(ivp).discrete_y().shape == (10, 5, 5, 2)


def test_cahn_hilliard_mixed_lhs():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.2, 0.2])
    cp = ConstrainedProblem(
        CahnHilliardEquation(2), mesh, [(_zero_neumann(2),) * 2] * 2
    )
    rng = np.random.default_rng(0)
    y_0 = 0.05 * rng.uniform(-1.0, 1.0, cp.y_shape(True))
    ic = DiscreteInitialCondition(cp, y_0, True)
    ivp = InitialValueProblem(cp, (0.0, 0.05), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    y = op.solve(ivp).discrete_y()
    assert y.shape == (10, 6, 6, 2)
    # the algebraic (LHS.Y) component equals mu = c^3 - c - gamma lap(c)
    assert np.all(np.isfinite(y))


def test_shallow_water_equation():
    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [1.0, 1.0])
    cp = ConstrainedProblem(
        ShallowWaterEquation(0.5), mesh, [(_zero_neumann(3),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp,
        [(np.full(2, 2.5), 0.25 * np.eye(2))] * 3,
        [1.0, 0.0, 0.0],
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    assert op.solve(ivp).discrete_y().shape == (10, 6, 6, 3)


def test_navier_stokes_equation():
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.2, 0.2])
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
    ivp = InitialValueProblem(cp, (0.0, 0.02), ic)
    op = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(tol=1e-6), 0.01
    )
    y = op.solve(ivp).discrete_y()
    assert y.shape == (2, 6, 6, 4)
    assert np.all(np.isfinite(y))


def test_polar_diffusion():
    mesh = Mesh(
        [(1.0, 5.0), (0.0, 2.0 * np.pi)],
        [0.5, np.pi / 4.0],
        CoordinateSystem.POLAR,
    )
    cp = ConstrainedProblem(
        DiffusionEquation(2), mesh, [(_zero_neumann(1),) * 2] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.array([3.0, np.pi]), np.eye(2))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    y = op.solve(ivp).discrete_y()
    assert y.shape == (10, 9, 9, 1)
    assert np.all(np.isfinite(y))


def test_dynamic_boundary_conditions():
    mesh = Mesh([(0.0, 1.0)], [0.1])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), 1), t)
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.1), mesh, [(bc, bc)])
    ic = ContinuousInitialCondition(cp, lambda x: np.zeros_like(x))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.1)
    y = op.solve(ivp).discrete_y()
    # boundary values track t at every output step
    t = np.linspace(0.1, 1.0, 10)
    assert np.allclose(y[:, 0, 0], t)
    assert np.allclose(y[:, -1, 0], t)


def test_trajectory_function_matches_solve():
    import jax.numpy as jnp

    mesh = Mesh([(0.0, 1.0)], [0.1])
    cp = ConstrainedProblem(
        DiffusionEquation(1), mesh, [(_zero_neumann(1),) * 2]
    )
    ic = GaussianInitialCondition(
        cp, [(np.array([0.5]), np.array([[0.05]]))]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)

    solution = op.solve(ivp)
    fn, t = op.trajectory_function(cp, (0.0, 0.5))
    ys = np.asarray(fn(jnp.asarray(ic.discrete_y_0(True)), 0.0))
    assert np.allclose(ys, solution.discrete_y())
    assert np.allclose(t, solution.t_coordinates)


def test_trajectory_function_rejects_dynamic_bcs():
    mesh = Mesh([(0.0, 1.0)], [0.1])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), 1), t)
    )
    cp = ConstrainedProblem(DiffusionEquation(1), mesh, [(bc, bc)])
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.1)
    with pytest.raises(ValueError):
        op.trajectory_function(cp, (0.0, 1.0))


def test_compiled_cache_ignores_stale_id_collisions():
    # an entry cached under a colliding id but for a DIFFERENT problem
    # object must be rebuilt, not reused (the reference rebuilds its
    # closures per solve, fdm_operator.py:48-77)
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [0.25, 0.25])
    bcs = [(_zero_neumann(1),) * 2] * 2
    cp_a = ConstrainedProblem(DiffusionEquation(2, 0.01), mesh, bcs)
    cp_b = ConstrainedProblem(DiffusionEquation(2, 10.0), mesh, bcs)
    ic = GaussianInitialCondition(
        cp_b, [(np.full(2, 0.5), 0.05 * np.eye(2))], [1.0]
    )
    ivp_b = InitialValueProblem(cp_b, (0.0, 0.02), ic)

    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    steps = 2

    def poisoned(y_0, t_0):  # pragma: no cover - must never run
        raise AssertionError("stale cache entry was reused")

    op._compiled_cache[(id(cp_b), steps, None)] = (cp_a, poisoned)
    y = op.solve(ivp_b).discrete_y()
    assert np.all(np.isfinite(y))
    # the rebuilt entry now pins cp_b
    assert op._compiled_cache[(id(cp_b), steps, None)][0] is cp_b


def _trapezoidal_mass(y):
    """Trapezoidal-weighted vertex sum (the invariant of zero-flux
    central-difference diffusion): boundary vertices weigh 1/2 per
    axis they terminate."""
    weights = np.ones(y.shape[:-1])
    for axis in range(weights.ndim):
        index = [slice(None)] * weights.ndim
        for edge in (0, -1):
            index[axis] = edge
            weights[tuple(index)] *= 0.5
    return float((weights[..., None] * y).sum())


@pytest.mark.parametrize(
    "integrator_factory", [CrankNicolsonMethod, BackwardEulerMethod]
)
def test_implicit_integrator_with_neumann_diffusion(integrator_factory):
    # implicit time stepping inside the FDM operator must preserve the
    # zero-flux invariant (mass conservation) and stay close to the
    # explicit RK4 solution
    mesh = Mesh([(0.0, 2.0), (0.0, 2.0)], [0.2, 0.2])
    bcs = [(_zero_neumann(1),) * 2] * 2
    cp = ConstrainedProblem(DiffusionEquation(2, 0.5), mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 1.0), 0.1 * np.eye(2))], [5.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.2), ic)

    implicit_op = FDMOperator(
        integrator_factory(), ThreePointCentralDifferenceMethod(), 0.01
    )
    explicit_op = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.01,
    )
    y_implicit = implicit_op.solve(ivp).discrete_y()
    y_explicit = explicit_op.solve(ivp).discrete_y()

    y_0 = np.asarray(ic.discrete_y_0(True))
    # the conserved discrete quantity under zero-flux central
    # differences is the trapezoidal-weighted sum
    assert np.isclose(
        _trapezoidal_mass(y_implicit[-1]),
        _trapezoidal_mass(y_0),
        rtol=1e-4,
    )
    if integrator_factory is BackwardEulerMethod:
        # first order: assert the deviation from RK4 shrinks ~linearly
        # with the step size rather than pinning a tight tolerance
        fine_op = FDMOperator(
            integrator_factory(),
            ThreePointCentralDifferenceMethod(),
            0.0025,
        )
        y_fine = fine_op.solve(ivp).discrete_y()
        coarse_error = np.abs(y_implicit[-1] - y_explicit[-1]).max()
        fine_error = np.abs(y_fine[-1] - y_explicit[-1]).max()
        assert fine_error < 0.4 * coarse_error
        assert coarse_error < 0.15
    else:
        assert np.allclose(y_implicit, y_explicit, atol=5e-3)
    assert np.all(np.isfinite(y_implicit))


def test_implicit_integrator_with_dirichlet_boundaries():
    mesh = Mesh([(0.0, 1.0)], [0.05])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), 1), 1.0), is_static=True
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.3), mesh, [(bc, bc)])
    ic = ContinuousInitialCondition(
        cp, lambda x: 1.0 + np.sin(np.pi * x)
    )
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    op = FDMOperator(
        CrankNicolsonMethod(), ThreePointCentralDifferenceMethod(), 0.01
    )
    y = op.solve(ivp).discrete_y()
    # sin mode decays as exp(-d pi^2 t) toward the boundary value 1
    x = np.linspace(0.0, 1.0, 21)
    t_end = 1.0
    expected = 1.0 + np.sin(np.pi * x) * np.exp(
        -0.3 * np.pi**2 * t_end
    )
    assert np.allclose(y[-1, :, 0], expected, atol=5e-3)
    assert np.allclose(y[:, 0, 0], 1.0) and np.allclose(y[:, -1, 0], 1.0)


def test_3d_diffusion_conserves_mass():
    mesh = Mesh([(0.0, 1.0)] * 3, [0.125] * 3)
    bcs = [(_zero_neumann(1),) * 2] * 3
    cp = ConstrainedProblem(DiffusionEquation(3, 0.2), mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.full(3, 0.5), 0.05 * np.eye(3))], [1.0]
    )
    ivp = InitialValueProblem(cp, (0.0, 0.1), ic)
    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.0025)
    y = op.solve(ivp).discrete_y()
    y_0 = np.asarray(ic.discrete_y_0(True))
    assert y.shape == (40, 9, 9, 9, 1)
    assert np.isclose(
        _trapezoidal_mass(y[-1]), _trapezoidal_mass(y_0), rtol=1e-4
    )
    # the peak must decay monotonically under pure diffusion
    peaks = y.max(axis=(1, 2, 3, 4))
    assert np.all(np.diff(peaks) < 0)


def test_ends_function_matches_trajectory_last_frame():
    # the carry-only generic ends scan must be bit-identical to the
    # trajectory's final frame (same step function, same order)
    import jax.numpy as jnp

    mesh = Mesh([(0.0, 2.0), (0.0, 2.0)], [0.25, 0.25])
    bc = _zero_neumann(1)
    cp = ConstrainedProblem(
        DiffusionEquation(2, 0.2), mesh, [(bc, bc)] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 1.0), 0.2 * np.eye(2))]
    )
    y_0 = jnp.asarray(ic.discrete_y_0(True))

    op = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.01,
    )
    trajectory, _ = op.trajectory_function(cp, (0.0, 0.1))
    ends = op.ends_function(cp, (0.0, 0.1))
    # Parareal vmaps the ends over a device's slices
    _assert_vmaps_like_calls(ends, y_0, jnp.asarray(0.0))
    np.testing.assert_array_equal(
        np.asarray(ends(y_0, jnp.asarray(0.0))),
        np.asarray(trajectory(y_0, jnp.asarray(0.0))[-1]),
    )


def _assert_vmaps_like_calls(fn, y_0, second_arg):
    import jax
    import jax.numpy as jnp

    batch = jnp.stack([y_0, 0.5 * y_0])
    batched = np.asarray(
        jax.vmap(fn, in_axes=(0, None))(batch, second_arg)
    )
    for k in range(2):
        np.testing.assert_allclose(
            batched[k], np.asarray(fn(batch[k], second_arg)), rtol=1e-12
        )


def test_indexed_ends_function_matches_indexed_trajectory():
    # dynamic boundary conditions: the carry-only indexed ends must be
    # bit-identical to the indexed trajectory's final frame per slice
    import jax.numpy as jnp

    mesh = Mesh([(0.0, 2.0), (0.0, 2.0)], [0.25, 0.25])
    bcs = [
        (
            DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), np.sin(t))
            ),
        )
        * 2,
        (_zero_neumann(1),) * 2,
    ]
    cp = ConstrainedProblem(DiffusionEquation(2, 0.5), mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 1.0), 0.2 * np.eye(2))]
    )
    y_0 = jnp.asarray(ic.discrete_y_0(True))

    op = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    trajectory = op.indexed_trajectory_function(cp, 0.0, 0.25, 4)
    ends = op.indexed_ends_function(cp, 0.0, 0.25, 4)
    _assert_vmaps_like_calls(ends, y_0, jnp.asarray(1))

    y = y_0
    for k in range(4):
        k_arr = jnp.asarray(k)
        traj = np.asarray(trajectory(y, k_arr))
        np.testing.assert_array_equal(
            np.asarray(ends(y, k_arr)), traj[-1]
        )
        y = jnp.asarray(traj[-1])
