import numpy as np
import pytest

from pararealml_tpu import (
    ConstrainedProblem,
    ContinuousInitialCondition,
    DiffusionEquation,
    GaussianInitialCondition,
    InitialValueProblem,
    LorenzEquation,
    Mesh,
    NeumannBoundaryCondition,
)
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    RK4,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu.operators.ode import ODEOperator
from pararealml_tpu.operators.parareal import PararealOperator


def _lorenz_ivp(t_end=4.0):
    cp = ConstrainedProblem(LorenzEquation())
    ic = ContinuousInitialCondition(cp, lambda _: np.ones(3))
    return InitialValueProblem(cp, (0.0, t_end), ic)


def _diffusion_ivp():
    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [0.5, 0.5])
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(
        DiffusionEquation(2, 0.2), mesh, [(bc, bc)] * 2
    )
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 2.5), 0.5 * np.eye(2))]
    )
    return InitialValueProblem(cp, (0.0, 2.0), ic)


def test_invalid_fine_step_size():
    ivp = _lorenz_ivp()
    f = ODEOperator("RK45", 0.3)
    g = ODEOperator("RK45", 0.5)
    with pytest.raises(ValueError):
        PararealOperator(f, g, 1e-3, num_time_slices=8).solve(ivp)


def test_invalid_coarse_step_size():
    ivp = _lorenz_ivp()
    f = ODEOperator("RK45", 0.05)
    g = ODEOperator("RK45", 0.3)
    with pytest.raises(ValueError):
        PararealOperator(f, g, 1e-3, num_time_slices=8).solve(ivp)


def test_tolerance_length_mismatch():
    ivp = _lorenz_ivp()
    f = ODEOperator("RK45", 0.05)
    g = ODEOperator("RK45", 0.25)
    with pytest.raises(ValueError):
        PararealOperator(f, g, [1e-3, 1e-3], num_time_slices=8).solve(
            ivp
        )


def test_serial_mode_equals_fine_solve():
    ivp = _lorenz_ivp()
    f = ODEOperator("RK45", 0.05)
    g = ODEOperator("RK45", 0.25)
    parareal = PararealOperator(f, g, 1e-4)
    serial = parareal.solve(ivp, parallel_enabled=False).discrete_y()
    fine = f.solve(ivp).discrete_y()
    assert np.array_equal(serial, fine)


def test_ode_parareal_matches_fine_solve():
    ivp = _lorenz_ivp()
    f = ODEOperator("RK45", 0.005, rtol=1e-10, atol=1e-13)
    g = ODEOperator("RK45", 0.005, rtol=1e-4, atol=1e-7)
    parareal = PararealOperator(f, g, 1e-11, num_time_slices=8)

    fine = f.solve(ivp).discrete_y()
    result = parareal.solve(ivp)
    assert result.d_t == f.d_t
    assert np.allclose(result.discrete_y(), fine, atol=1e-7)


def test_pde_parareal_matches_fine_solve():
    ivp = _diffusion_ivp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)
    parareal = PararealOperator(f, g, 1e-8, num_time_slices=8)

    fine = f.solve(ivp).discrete_y()
    result = parareal.solve(ivp).discrete_y()
    assert result.shape == fine.shape
    assert np.allclose(result, fine, atol=1e-5)


def test_mixed_fine_coarse_operator_types():
    ivp = _lorenz_ivp(t_end=2.0)
    f = ODEOperator("RK45", 0.005, rtol=1e-10, atol=1e-13)
    g = ODEOperator("RK4", 0.025)
    parareal = PararealOperator(f, g, 1e-11, num_time_slices=8)
    fine = f.solve(ivp).discrete_y()
    assert np.allclose(
        parareal.solve(ivp).discrete_y(), fine, atol=1e-6
    )


def test_callable_termination_uses_host_path():
    ivp = _lorenz_ivp(t_end=2.0)
    f = ODEOperator("RK45", 0.01, rtol=1e-10, atol=1e-13)
    g = ODEOperator("RK45", 0.05, rtol=1e-4, atol=1e-7)
    calls = []

    def termination(old, new):
        calls.append(np.abs(new - old).max())
        return np.abs(new - old).max() < 1e-10

    parareal = PararealOperator(f, g, termination, num_time_slices=4)
    fine = f.solve(ivp).discrete_y()
    assert np.allclose(
        parareal.solve(ivp).discrete_y(), fine, atol=1e-6
    )
    assert len(calls) >= 1


def test_more_slices_than_devices_uses_host_path():
    ivp = _lorenz_ivp(t_end=3.0)
    f = ODEOperator("RK45", 0.01, rtol=1e-10, atol=1e-13)
    g = ODEOperator("RK45", 0.05, rtol=1e-4, atol=1e-7)
    parareal = PararealOperator(f, g, 1e-11, num_time_slices=12)
    fine = f.solve(ivp).discrete_y()
    assert np.allclose(
        parareal.solve(ivp).discrete_y(), fine, atol=1e-6
    )


def test_max_iterations_limits_accuracy():
    ivp = _diffusion_ivp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)
    one_iter = PararealOperator(
        f, g, 0.0, max_iterations=1, num_time_slices=8
    )
    full = PararealOperator(
        f, g, 0.0, max_iterations=8, num_time_slices=8
    )
    fine = f.solve(ivp).discrete_y()
    error_one = np.abs(one_iter.solve(ivp).discrete_y() - fine).max()
    error_full = np.abs(full.solve(ivp).discrete_y() - fine).max()
    assert error_full < error_one
    assert error_full < 1e-8


def test_vmap_batched_slices_on_fewer_devices():
    import jax

    ivp = _lorenz_ivp(t_end=4.0)
    f = ODEOperator("RK45", 0.005, rtol=1e-10, atol=1e-13)
    g = ODEOperator("RK45", 0.005, rtol=1e-4, atol=1e-7)
    # 16 slices on 8 devices: 2 fine solves batched per device
    parareal = PararealOperator(f, g, 1e-11, num_time_slices=16)
    fine = f.solve(ivp).discrete_y()
    assert np.allclose(
        parareal.solve(ivp).discrete_y(), fine, atol=1e-6
    )

    # 8 slices on a single device: pure-vmap parallel-in-time
    single_device = PararealOperator(
        f, g, 1e-11, num_time_slices=8, devices=[jax.devices()[0]]
    )
    assert np.allclose(
        single_device.solve(ivp).discrete_y(), fine, atol=1e-6
    )


def test_vmap_batched_pde_parareal():
    import jax

    ivp = _diffusion_ivp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)
    parareal = PararealOperator(
        f, g, 1e-8, num_time_slices=8, devices=[jax.devices()[0]]
    )
    fine = f.solve(ivp).discrete_y()
    assert np.allclose(
        parareal.solve(ivp).discrete_y(), fine, atol=1e-5
    )


def _dynamic_bc_diffusion_ivp(t_end=1.0):
    from pararealml_tpu import DirichletBoundaryCondition

    mesh = Mesh([(0.0, 2.0), (0.0, 2.0)], [0.25, 0.25])
    bcs = [
        (
            DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), np.sin(t))
            ),
            DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 0.5 * t)
            ),
        ),
        (
            NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
        * 2,
    ]
    cp = ConstrainedProblem(DiffusionEquation(2, 0.5), mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.full(2, 1.0), 0.2 * np.eye(2))], [2.0]
    )
    return InitialValueProblem(cp, (0.0, t_end), ic)


def test_dynamic_bc_parareal_takes_compiled_path_and_matches_fine():
    # dynamic boundary conditions no longer force the host fallback:
    # constraints are pre-evaluated on the whole domain's half-step
    # grid and each slice indexes its window (VERDICT.md item 6)
    ivp = _dynamic_bc_diffusion_ivp()
    cp = ivp.constrained_problem
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.025)
    parareal = PararealOperator(f, g, 1e-6, num_time_slices=4)

    assert parareal._can_compile(cp, 4)

    fine = f.solve(ivp).discrete_y()
    result = parareal.solve(ivp).discrete_y()
    assert result.shape == fine.shape
    assert np.allclose(result, fine, atol=1e-4)
    # the boundary values must track the time-dependent conditions
    t = np.arange(0.005, 1.0025, 0.005)
    assert np.allclose(result[:, 0, 1:-1, 0], np.sin(t)[:, None],
                       atol=1e-6)
    assert np.allclose(result[:, -1, 1:-1, 0], 0.5 * t[:, None],
                       atol=1e-6)


def test_dynamic_bc_parareal_vmap_batched():
    ivp = _dynamic_bc_diffusion_ivp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.0125)
    g = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.03125
    )
    # 16 slices on at most 8 devices -> vmap batching with dynamic BCs
    parareal = PararealOperator(f, g, 1e-6, num_time_slices=16)
    fine = f.solve(ivp).discrete_y()
    result = parareal.solve(ivp).discrete_y()
    assert np.allclose(result, fine, atol=1e-4)


def test_stiff_radau_parareal_matches_fine_solve():
    # parallel-in-time solution of a stiff problem with implicit
    # adaptive Radau as both fine and coarse operator (the reference
    # reaches this configuration through SciPy's stiff solvers)
    from pararealml_tpu import VanDerPolEquation

    cp = ConstrainedProblem(VanDerPolEquation(50.0))
    ic = ContinuousInitialCondition(cp, lambda _: np.array([2.0, 0.0]))
    ivp = InitialValueProblem(cp, (0.0, 8.0), ic)

    f = ODEOperator("Radau", 0.1, rtol=1e-9, atol=1e-10)
    g = ODEOperator("Radau", 0.5, rtol=1e-4, atol=1e-6)
    parareal = PararealOperator(f, g, 1e-7, num_time_slices=8)
    assert parareal._can_compile(cp, 8)

    fine = f.solve(ivp).discrete_y()
    result = parareal.solve(ivp).discrete_y()
    assert result.shape == fine.shape
    assert np.allclose(result, fine, atol=1e-5)


def test_trajectory_function_validates_step_sizes():
    # trajectory_function must apply the same d_t-divisibility checks
    # as solve(), not silently integrate a truncated slice
    cp = ConstrainedProblem(LorenzEquation())
    f = ODEOperator("RK4", 0.1)
    g = ODEOperator("RK4", 0.125)
    parareal = PararealOperator(f, g, 1e-6, num_time_slices=8)
    with pytest.raises(ValueError):
        parareal.trajectory_function(cp, (0.0, 1.0))


def test_trajectory_function_uses_operator_orientation():
    # the compiled program must be built (and cached) for the
    # operator's vertex orientation, not hardcoded vertices
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)
    parareal = PararealOperator(f, g, 1e-8, num_time_slices=8)
    fn, t = parareal.trajectory_function(cp, (0.0, 2.0))
    import jax.numpy as jnp

    y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))
    ys = fn(y_0, jnp.asarray(0.0, y_0.dtype))
    assert ys.shape == (len(t),) + tuple(cp.y_shape(True))
    # a subsequent solve() must not collide with the cached program
    result = parareal.solve(ivp).discrete_y()
    assert np.allclose(result, np.asarray(ys), atol=1e-8)


def test_invalid_relaxation_rejected():
    f = ODEOperator("RK45", 0.05)
    g = ODEOperator("RK45", 0.25)
    with pytest.raises(ValueError):
        PararealOperator(f, g, 1e-3, relaxation="cfc")


def test_fcf_parareal_matches_fine_solve_compiled():
    # compiled shard_map path (8 slices on the 8-device virtual mesh)
    ivp = _diffusion_ivp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.025)
    parareal = PararealOperator(
        f, g, 1e-5, num_time_slices=8, relaxation="fcf"
    )
    result = parareal.solve(ivp).discrete_y()
    fine = f.solve(ivp).discrete_y()
    assert result.shape == fine.shape
    assert np.abs(result - fine).max() < 1e-4


def test_fcf_doubles_the_exactness_horizon():
    # after k iterations classic Parareal has borders 1..k exact while
    # FCF has 1..2k: with k = 2 on 8 slices, slice borders 3 and 4 must
    # be at fine-solver accuracy under FCF but not under classic
    ivp = _lorenz_ivp(t_end=2.0)
    f = ODEOperator("RK45", 0.01, rtol=1e-10, atol=1e-12)
    g = ODEOperator("RK45", 0.125)
    fine = f.solve(ivp).discrete_y()
    n = 8
    steps_per_slice = fine.shape[0] // n

    def border_errors(relaxation):
        op = PararealOperator(
            f,
            g,
            None,
            max_iterations=2,
            num_time_slices=n,
            relaxation=relaxation,
        )
        y = op.solve(ivp).discrete_y()
        ends = y[steps_per_slice - 1 :: steps_per_slice]
        fine_ends = fine[steps_per_slice - 1 :: steps_per_slice]
        return np.abs(ends - fine_ends).max(axis=1)

    e_classic = border_errors("f")
    e_fcf = border_errors("fcf")
    # both have borders 1 and 2 exact after two iterations
    assert e_classic[:2].max() < 1e-8
    assert e_fcf[:2].max() < 1e-8
    # FCF additionally has borders 3 and 4 exact; classic does not
    assert e_fcf[2:4].max() < 1e-8
    assert e_classic[2:4].max() > 1e-7
    assert e_fcf[2:4].max() < e_classic[2:4].max() / 100


def test_fcf_host_path_matches_fine_solve():
    # a callable termination condition forces the host fallback
    ivp = _lorenz_ivp(t_end=2.0)
    f = ODEOperator("RK45", 0.01, rtol=1e-10, atol=1e-12)
    g = ODEOperator("RK45", 0.125)
    calls = []

    def termination(old, new):
        calls.append(1)
        return bool(np.abs(new - old).max() < 1e-9)

    parareal = PararealOperator(
        f, g, termination, num_time_slices=8, relaxation="fcf"
    )
    result = parareal.solve(ivp).discrete_y()
    fine = f.solve(ivp).discrete_y()
    assert calls
    assert np.abs(result - fine).max() < 1e-6


def test_fcf_vmap_batched_slices():
    # more slices than devices: the second fine sweep and the batched
    # coarse re-predictions run under vmap
    ivp = _diffusion_ivp()
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.025)
    parareal = PararealOperator(
        f, g, 1e-5, num_time_slices=16, relaxation="fcf"
    )
    result = parareal.solve(ivp).discrete_y()
    fine = f.solve(ivp).discrete_y()
    assert result.shape == fine.shape
    assert np.abs(result - fine).max() < 1e-4


@pytest.mark.slow
def test_tune_num_time_slices():
    ivp = _diffusion_ivp()
    f = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.01,
    )
    g = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.05,
    )
    parareal = PararealOperator(f, g, 1e-3)

    best = parareal.tune_num_time_slices(
        ivp, candidates=(8, 40), repeats=1
    )
    assert best in (8, 40)
    assert parareal._num_time_slices == best

    # the tuned operator still solves correctly
    y = parareal.solve(ivp).discrete_y()
    fine_y = f.solve(ivp).discrete_y()
    assert np.max(np.abs(y - fine_y)) < 1e-2

    # default candidate generation filters incompatible counts
    best_default = parareal.tune_num_time_slices(ivp, repeats=1)
    assert best_default % 8 == 0

    # a candidate whose slice duration the step sizes cannot divide
    # is rejected before timing
    with pytest.raises(ValueError, match="divisor"):
        parareal.tune_num_time_slices(
            ivp, candidates=(24,), repeats=1
        )


def test_tune_candidate_validation():
    ivp = _diffusion_ivp()
    f = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.01,
    )
    g = FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.05,
    )
    parareal = PararealOperator(f, g, 1e-3, num_time_slices=8)

    with pytest.raises(ValueError, match="must not be empty"):
        parareal.tune_num_time_slices(ivp, candidates=())
    # a count that is not a device multiple would be timed on the
    # host fallback — a different schedule — so it is rejected
    with pytest.raises(ValueError, match="multiple of the device"):
        parareal.tune_num_time_slices(ivp, candidates=(8, 20))
    with pytest.raises(ValueError, match="multiple of the device"):
        parareal.tune_num_time_slices(ivp, candidates=(0,))
    # failed tuning leaves the configured count untouched
    assert parareal._num_time_slices == 8


def test_nonlinear_quadratic_ml_coarse_parareal_matches_fine():
    """Parareal with a TRAINED NONLINEAR surrogate coarse operator on a
    problem whose slice jump is NOT affine (2D viscous Burgers) — the
    reference's ML-coarse composition
    (/root/reference/pararealml/operators/parareal/
    parareal_operator.py:102-197 with an ML ``g``,
    /root/reference/README.md:9-13) beyond the affine-ridge special
    case. The coarse operator is a reduced-quadratic state-operator
    fit (closed-form ridge of linear + POD-subspace-quadratic terms)
    trained on fine trajectories of perturbed initial conditions."""
    from pararealml_tpu import BurgersEquation
    from pararealml_tpu.operators.ml.supervised import (
        ReducedQuadraticStateOperatorRegressor,
        SupervisedMLOperator,
    )

    mesh = Mesh([(0.0, 5.0), (0.0, 5.0)], [0.5, 0.5])
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = ConstrainedProblem(
        BurgersEquation(2, 100.0), mesh, [(bc, bc)] * 2
    )
    ic = GaussianInitialCondition(
        cp,
        [(np.full(2, 2.5), 0.75 * np.eye(2))] * 2,
        [1.0, 0.5],
    )
    t_end = 2.0
    ivp = InitialValueProblem(cp, (0.0, t_end), ic)
    n_y = int(np.prod(cp.y_shape(True)))

    f = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.005
    )
    n_slices = 8
    sml = SupervisedMLOperator(t_end / n_slices, True)
    np.random.seed(0)
    data = sml.generate_data(
        ivp,
        f,
        6,
        lambda t, y: y * np.random.uniform(0.9, 1.1, size=y.shape),
    )
    model = ReducedQuadraticStateOperatorRegressor(n_y, rank=8)
    train_mse, test_mse = sml.fit_model(model, data)
    assert train_mse < 1e-8
    assert test_mse < 1e-4

    import jax.numpy as jnp

    parareal = PararealOperator(
        f, sml, 0.005, num_time_slices=n_slices, max_iterations=4
    )
    fn, _ = parareal.trajectory_function(cp, (0.0, t_end))
    fine_fn, _ = f.trajectory_function(cp, (0.0, t_end))
    y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))
    parareal_y = np.asarray(fn(y_0, jnp.asarray(0.0, y_0.dtype)))
    fine_y = np.asarray(fine_fn(y_0, jnp.asarray(0.0, y_0.dtype)))
    assert parareal_y.shape == fine_y.shape
    # the quadratic surrogate captures the nonlinear slice jump well
    # enough that a handful of Parareal corrections reach fine accuracy
    assert np.max(np.abs(parareal_y - fine_y)) < 0.005


def test_invalid_materialize_rejected():
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)
    with pytest.raises(ValueError, match="materialize"):
        PararealOperator(f, g, 1e-8, materialize="eager")


def test_iteration_materialization_matches_final():
    """``materialize="iteration"`` (the reference's schedule — keep the
    last iteration's fine trajectories and shift them,
    /root/reference/pararealml/operators/parareal/
    parareal_operator.py:163-193) must agree with the default
    final-borders expansion to correction accuracy, share its slice
    END states bit-for-bit after the shift, and still match the fine
    solve within tolerance."""
    import jax.numpy as jnp

    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    f = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.01
    )
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.05)
    y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))
    t_0 = jnp.asarray(0.0, y_0.dtype)

    fine_fn, _ = f.trajectory_function(cp, ivp.t_interval)
    fine = np.asarray(fine_fn(y_0, t_0))

    results = {}
    for materialize in ("final", "iteration"):
        parareal = PararealOperator(
            f, g, 1e-8, num_time_slices=8, materialize=materialize
        )
        fn, _ = parareal.trajectory_function(cp, ivp.t_interval)
        results[materialize] = np.asarray(fn(y_0, t_0))

    for materialize, y in results.items():
        assert y.shape == fine.shape
        assert np.max(np.abs(y - fine)) < 1e-5, materialize
    # slice END states are shifted onto each mode's corrected borders,
    # which agree to correction accuracy (the two modes' fine end
    # states come from differently-compiled but mathematically equal
    # programs, so bit identity is not promised)
    steps_per_slice = len(fine) // 8
    ends = slice(steps_per_slice - 1, None, steps_per_slice)
    np.testing.assert_allclose(
        results["final"][ends],
        results["iteration"][ends],
        atol=1e-6,
    )


def test_one_shot_iteration_packed_raw_path_exact_with_exact_coarse():
    """max_iterations=1 + "iteration" materialization over vmap-batched
    slices (more slices than devices on a small grid); with the coarse
    operator EQUAL to the fine one, a single iteration must reproduce
    the fine solve to float32 accuracy."""
    import jax
    import jax.numpy as jnp
    from pararealml_tpu import BurgersEquation

    mesh = Mesh([(0.0, 4.0), (0.0, 4.0)], [0.5, 0.5])
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = ConstrainedProblem(
        BurgersEquation(2, 50.0), mesh, [(bc, bc)] * 2
    )
    ic = GaussianInitialCondition(
        cp,
        [(np.full(2, 2.0), 0.5 * np.eye(2))] * 2,
        [0.5, 0.25],
    )
    t_end = 1.6
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    y_0 = jnp.asarray(
        np.asarray(ic.discrete_y_0(True), np.float32)
    )
    t_0 = jnp.asarray(0.0, y_0.dtype)
    fine_fn, _ = f.trajectory_function(cp, (0.0, t_end))
    fine = np.asarray(jax.jit(fine_fn)(y_0, t_0))

    parareal = PararealOperator(
        f,
        FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005),
        1e-6,
        num_time_slices=16,
        max_iterations=1,
        materialize="iteration",
    )
    fn, _ = parareal.trajectory_function(cp, (0.0, t_end))
    y = np.asarray(fn(y_0, t_0))
    assert y.shape == fine.shape
    assert np.max(np.abs(y - fine)) < 1e-4


def test_iteration_materialization_packed_batched_path():
    """"iteration" materialization over vmap-batched slice
    trajectories (more slices than devices on a small grid)."""
    import jax
    import jax.numpy as jnp
    from pararealml_tpu import BurgersEquation

    mesh = Mesh([(0.0, 4.0), (0.0, 4.0)], [0.5, 0.5])
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = ConstrainedProblem(
        BurgersEquation(2, 50.0), mesh, [(bc, bc)] * 2
    )
    ic = GaussianInitialCondition(
        cp,
        [(np.full(2, 2.0), 0.5 * np.eye(2))] * 2,
        [0.5, 0.25],
    )
    t_end = 1.6
    ivp = InitialValueProblem(cp, (0.0, t_end), ic)
    f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.1)
    y_0 = jnp.asarray(
        np.asarray(ic.discrete_y_0(True), np.float32)
    )
    t_0 = jnp.asarray(0.0, y_0.dtype)

    fine_fn, _ = f.trajectory_function(cp, (0.0, t_end))
    fine = np.asarray(jax.jit(fine_fn)(y_0, t_0))
    parareal = PararealOperator(
        f, g, 1e-6, num_time_slices=16, materialize="iteration"
    )
    fn, _ = parareal.trajectory_function(cp, (0.0, t_end))
    y = np.asarray(fn(y_0, t_0))
    assert y.shape == fine.shape
    assert np.max(np.abs(y - fine)) < 1e-4
