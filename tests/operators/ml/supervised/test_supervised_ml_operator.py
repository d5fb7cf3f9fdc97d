import jax
import numpy as np
import pytest

from pararealml_tpu import (
    ConstrainedProblem,
    PopulationGrowthEquation,
    ContinuousInitialCondition,
    DiffusionEquation,
    GaussianInitialCondition,
    InitialValueProblem,
    LotkaVolterraEquation,
    Mesh,
    NeumannBoundaryCondition,
)
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    RK4,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu.operators.ml import (
    FNN,
    SKLearnJaxRegressor,
    SupervisedMLOperator,
)
from pararealml_tpu.operators.ode import ODEOperator


def _scaled_lotka_volterra_ivp(t_end=1.0):
    cp = ConstrainedProblem(LotkaVolterraEquation(2.0, 4.0, 1.06, 2.0))
    ic = ContinuousInitialCondition(
        cp, lambda _: np.array([1.0, 0.15])
    )
    return InitialValueProblem(cp, (0.0, t_end), ic)


def _diffusion_ivp():
    mesh = Mesh([(0.0, 1.0)], [0.25])
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.1), mesh, [(bc, bc)])
    ic = GaussianInitialCondition(
        cp, [(np.array([0.5]), np.array([[0.1]]))]
    )
    return InitialValueProblem(cp, (0.0, 0.5), ic)


def test_mode_validation():
    with pytest.raises(ValueError):
        SupervisedMLOperator(
            0.1, None, auto_regressive=False, time_variant=False
        )
    with pytest.raises(ValueError):
        SupervisedMLOperator(
            0.1, None, time_variant=True, input_d_t=True
        )


def test_solve_requires_model():
    with pytest.raises(ValueError):
        SupervisedMLOperator(0.1, None).solve(
            _scaled_lotka_volterra_ivp()
        )


def test_generate_data_validation():
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.1, None)
    with pytest.raises(ValueError):
        op.generate_data(ivp, oracle, 0, lambda t, y: y)
    with pytest.raises(ValueError):
        op.generate_data(ivp, oracle, 1, lambda t, y: y, n_jobs=0)
    with pytest.raises(ValueError):
        op.generate_data(
            ivp, oracle, 1, lambda t, y: y, n_jobs=2, seeds=[0]
        )
    with pytest.raises(ValueError):
        op.generate_data(
            ivp, oracle, 1, lambda t, y: np.zeros(5)
        )


def test_ode_data_layout_auto_regressive():
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, auto_regressive=True)
    inputs, targets = op.generate_data(
        ivp, oracle, 2, lambda t, y: y
    )
    # 2 iterations x 4 steps x 1 row, input = y (2), target = y (2)
    assert inputs.shape == (8, 2)
    assert targets.shape == (8, 2)
    # with identity perturbation, inputs chain through targets
    assert np.allclose(inputs[1], targets[0])


def test_ode_data_layout_time_variant():
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(
        0.25, None, auto_regressive=False, time_variant=True
    )
    inputs, targets = op.generate_data(ivp, oracle, 2, lambda t, y: y)
    assert inputs.shape == (8, 3)
    # t column holds the target times
    assert np.allclose(inputs[:4, 2], [0.25, 0.5, 0.75, 1.0])
    # non-auto-regressive: every row's state features are the initial y
    assert np.allclose(inputs[:, :2], inputs[0, :2])


def test_ode_data_layout_input_d_t():
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, input_d_t=True)
    inputs, _ = op.generate_data(ivp, oracle, 1, lambda t, y: y)
    assert inputs.shape == (4, 3)
    assert np.allclose(inputs[:, 2], 0.25)


def test_pde_data_layout():
    ivp = _diffusion_ivp()
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.025
    )
    op = SupervisedMLOperator(0.25, True, auto_regressive=True)
    inputs, targets = op.generate_data(ivp, oracle, 1, lambda t, y: y)
    # 5 mesh points, 2 steps: rows = 2 * 5; features = 5 states + x
    assert inputs.shape == (10, 6)
    assert targets.shape == (10, 1)
    # last column is the mesh coordinates
    assert np.allclose(inputs[:5, -1], np.linspace(0.0, 1.0, 5))


def test_batched_and_sequential_generation_agree():
    ivp = _scaled_lotka_volterra_ivp()
    jax_oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, auto_regressive=True)

    batched_inputs, batched_targets = op.generate_data(
        ivp, jax_oracle, 2, lambda t, y: y
    )
    sequential_inputs, sequential_targets = (
        op._generate_data_sequential(
            ivp, jax_oracle, 2, lambda t, y: y, False, False
        )
    )
    assert np.allclose(batched_inputs, sequential_inputs, atol=1e-10)
    assert np.allclose(batched_targets, sequential_targets, atol=1e-10)


def test_train_solve_roundtrip_with_flax_model():
    np.random.seed(0)
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK45", 0.01, rtol=1e-8, atol=1e-10)
    op = SupervisedMLOperator(0.1, None, auto_regressive=True)
    import optax

    model = SKLearnJaxRegressor(
        lambda: FNN([32, 32, 2]),
        batch_size=128,
        epochs=300,
        verbose=0,
        seed=0,
        optimizer=optax.adam(3e-3),
    )
    train_score, test_score = op.train(
        ivp,
        oracle,
        model,
        iterations=20,
        perturbation_function=lambda t, y: y
        * np.random.uniform(0.95, 1.05, y.shape),
    )
    assert train_score < 5e-3
    assert test_score < 5e-3

    solution = op.solve(ivp)
    fine = oracle.solve(ivp).discrete_y()[9::10]
    assert solution.discrete_y().shape == fine.shape
    # one-step-trained surrogate stays within a loose envelope over a
    # short roll-out
    assert (
        np.abs(solution.discrete_y() - fine).max()
        / np.abs(fine).max()
        < 0.25
    )


def test_train_with_sklearn_model():
    from sklearn.ensemble import RandomForestRegressor

    np.random.seed(0)
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, auto_regressive=True)
    train_score, test_score = op.train(
        ivp,
        oracle,
        RandomForestRegressor(max_depth=8, n_estimators=20),
        iterations=10,
        perturbation_function=lambda t, y: y
        * np.random.uniform(0.9, 1.1, y.shape),
    )
    assert np.isfinite(train_score) and np.isfinite(test_score)
    assert op.solve(ivp).discrete_y().shape == (4, 2)


def test_trajectory_function_matches_solve():
    np.random.seed(0)
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, auto_regressive=True)
    model = SKLearnJaxRegressor(
        lambda: FNN([16, 2]), batch_size=64, epochs=50, verbose=0
    )
    op.train(ivp, oracle, model, 5, lambda t, y: y)

    solution = op.solve(ivp).discrete_y()
    fn, t = op.trajectory_function(
        ivp.constrained_problem, (0.0, 1.0)
    )
    rollout = np.asarray(jax.jit(fn)(np.array([1.0, 0.15]), 0.0))
    assert np.allclose(rollout, solution, atol=1e-10)
    assert np.allclose(t, [0.25, 0.5, 0.75, 1.0])


def test_trajectory_function_requires_flax_model():
    from sklearn.linear_model import LinearRegression

    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, auto_regressive=True)
    op.train(ivp, oracle, LinearRegression(), 3, lambda t, y: y)
    with pytest.raises(ValueError):
        op.trajectory_function(ivp.constrained_problem, (0.0, 1.0))


def test_isolate_perturbations():
    np.random.seed(0)
    ivp = _scaled_lotka_volterra_ivp()
    oracle = ODEOperator("RK4", 0.01)
    op = SupervisedMLOperator(0.25, None, auto_regressive=True)
    inputs, _ = op.generate_data(
        ivp,
        oracle,
        2,
        lambda t, y: y + 100.0,
        isolate_perturbations=True,
    )
    # the chain restarts from the unperturbed states, so inputs stay in
    # the perturbed-but-unpropagated range (y + 100, not y + 200+)
    assert inputs[:, :2].max() < 200.0


def test_ml_coarse_operator_inside_parareal():
    from pararealml_tpu.operators.parareal import PararealOperator

    np.random.seed(0)
    ivp = _scaled_lotka_volterra_ivp(t_end=2.0)
    oracle = ODEOperator("RK45", 0.005, rtol=1e-8, atol=1e-10)
    coarse_ml = SupervisedMLOperator(0.25, None, auto_regressive=True)
    model = SKLearnJaxRegressor(
        lambda: FNN([32, 32, 2]),
        batch_size=128,
        epochs=300,
        verbose=0,
        seed=0,
    )
    coarse_ml.train(
        ivp,
        oracle,
        model,
        iterations=20,
        perturbation_function=lambda t, y: y
        * np.random.uniform(0.9, 1.1, y.shape),
    )

    fine = ODEOperator("RK45", 0.005, rtol=1e-10, atol=1e-13)
    parareal = PararealOperator(
        fine, coarse_ml, 1e-9, num_time_slices=8
    )
    fine_y = fine.solve(ivp).discrete_y()
    parareal_y = parareal.solve(ivp).discrete_y()
    assert np.allclose(parareal_y, fine_y, atol=1e-5)


def test_data_generation_with_fused_capable_oracle():
    # the oracle solves are vmapped over the perturbed initial
    # conditions, in float32
    import jax as _jax

    _jax.config.update("jax_enable_x64", False)
    try:
        mesh = Mesh([(0.0, 4.0), (0.0, 4.0)], [0.5, 0.5])
        bc = NeumannBoundaryCondition(
            lambda x, t: np.zeros((len(x), 1)), is_static=True
        )
        cp = ConstrainedProblem(
            DiffusionEquation(2, 0.2), mesh, [(bc, bc)] * 2
        )
        ic = GaussianInitialCondition(
            cp, [(np.full(2, 2.0), np.eye(2))], [10.0]
        )
        ivp = InitialValueProblem(cp, (0.0, 0.2), ic)
        oracle = FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 0.01
        )
        operator = SupervisedMLOperator(0.1, True, auto_regressive=True)
        np.random.seed(0)
        inputs, targets = operator.generate_data(
            ivp,
            oracle,
            iterations=3,
            perturbation_function=lambda t, y: y
            * np.random.uniform(0.95, 1.05, y.shape),
        )
        assert np.all(np.isfinite(inputs))
        assert np.all(np.isfinite(targets))
    finally:
        _jax.config.update("jax_enable_x64", True)


def test_repeat_on_error_retries_failed_oracle_solves():
    # an oracle that fails intermittently must be retried with a fresh
    # perturbation instead of aborting data generation (the reference's
    # failure-detection behavior, supervised_ml_operator.py:568-578)
    cp = ConstrainedProblem(LotkaVolterraEquation(2.0, 1.0, 0.8, 1.0))
    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0, 0.5]))
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)

    class FlakyOracle(ODEOperator):
        def __init__(self):
            super().__init__("RK4", 0.05)
            self.calls = 0

        def solve(self, ivp_, parallel_enabled=True):
            self.calls += 1
            if self.calls % 3 == 0:
                raise RuntimeError("transient oracle failure")
            return super().solve(ivp_, parallel_enabled)

    oracle = FlakyOracle()
    operator = SupervisedMLOperator(0.25, None, auto_regressive=True)
    np.random.seed(0)
    with pytest.warns(UserWarning):
        inputs, targets = operator.generate_data(
            ivp,
            oracle,
            iterations=4,
            perturbation_function=lambda t, y: y
            * np.random.uniform(0.9, 1.1, y.shape),
            repeat_on_error=True,
        )
    assert np.all(np.isfinite(inputs))
    assert np.all(np.isfinite(targets))
    assert len(inputs) == 4 * 2  # iterations x time steps

    # without repeat_on_error the failure propagates (a host-only
    # oracle forces the sequential path, which calls solve per
    # iteration)
    from pararealml_tpu.operator import Operator

    class HostFlakyOracle(Operator):
        def __init__(self):
            super().__init__(0.05, None)
            self.calls = 0

        def solve(self, ivp_, parallel_enabled=True):
            self.calls += 1
            if self.calls >= 3:
                raise RuntimeError("oracle failure")
            return ODEOperator("RK4", 0.05).solve(
                ivp_, parallel_enabled
            )

    with pytest.raises(RuntimeError):
        SupervisedMLOperator(
            0.25, None, auto_regressive=True
        ).generate_data(
            ivp,
            HostFlakyOracle(),
            iterations=10,
            perturbation_function=lambda t, y: y,
        )


def test_time_variant_solve_roundtrip():
    # a time-variant (non-auto-regressive) operator predicts y(t)
    # directly from (y_0, t)
    np.random.seed(1)
    cp = ConstrainedProblem(PopulationGrowthEquation(1.0))
    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    oracle = ODEOperator("RK45", 0.1, rtol=1e-10, atol=1e-12)

    operator = SupervisedMLOperator(
        0.1, None, auto_regressive=False, time_variant=True
    )
    model = SKLearnJaxRegressor(
        lambda: FNN([32, 32, 1]),
        batch_size=32,
        epochs=400,
        verbose=0,
        seed=1,
    )
    operator.train(
        ivp,
        oracle,
        model,
        iterations=30,
        perturbation_function=lambda t, y: y
        * np.random.uniform(0.9, 1.1, y.shape),
    )
    y = operator.solve(ivp).discrete_y()
    exact = np.exp(np.arange(0.1, 1.05, 0.1))
    assert np.abs(y[:, 0] - exact).max() < 0.15


def test_pde_solve_roundtrip_with_input_d_t():
    # input-d_t mode on a PDE: the model sees (y_0, d_t, x) and learns
    # the solution jump; the reference's input layout drops the d_t
    # column for ODEs only (supervised_ml_operator.py:359-370)
    np.random.seed(4)
    from pararealml_tpu import DirichletBoundaryCondition

    mesh = Mesh([(0.0, 1.0)], [0.25])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.2), mesh, [(bc, bc)])
    ic = ContinuousInitialCondition(cp, lambda x: np.sin(np.pi * x))
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.0025
    )

    operator = SupervisedMLOperator(
        0.1, True, auto_regressive=True, input_d_t=True
    )
    model = SKLearnJaxRegressor(
        lambda: FNN([32, 32, 1]),
        batch_size=32,
        epochs=400,
        verbose=0,
        seed=4,
    )
    operator.train(
        ivp,
        oracle,
        model,
        iterations=40,
        perturbation_function=lambda t, y: y
        * np.random.uniform(0.9, 1.1, y.shape),
    )
    y = operator.solve(ivp).discrete_y()
    exact = oracle.solve(ivp).discrete_y()[
        np.rint(
            np.arange(0.1, 0.55, 0.1) / 0.0025
        ).astype(int)
        - 1
    ]
    assert y.shape == exact.shape
    # error compounds over 5 autoregressive model steps
    assert np.abs(y - exact).max() < 0.15


def test_trajectory_function_hoists_deeponet_trunk():
    # a (Standardized-wrapped) DeepONet whose branch consumes exactly
    # the flattened state takes the trunk-hoisted roll-out path; it
    # must agree with solve(), which predicts through the generic
    # tiled input layout
    import optax

    from pararealml_tpu.operators.ml import DeepONet, Standardized
    from pararealml_tpu.operators.ml.supervised.supervised_ml_operator import (  # noqa: E501
        SupervisedMLOperator as _Op,
    )

    np.random.seed(0)
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    n_y = int(np.prod(cp.y_shape(True)))
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.001
    )
    op = SupervisedMLOperator(0.25, True)
    data = op.generate_data(ivp, oracle, 3, lambda t, y: y * 1.01)

    def build():
        return Standardized.from_data(
            DeepONet(
                branch_net=FNN([8], activation=lambda h: h),
                trunk_net=FNN([16, 8]),
                combiner_net=FNN([1], activation=lambda h: h),
                branch_net_input_size=n_y,
            ),
            *data,
        )

    model = SKLearnJaxRegressor(
        build, batch_size=64, epochs=30,
        optimizer=optax.adam(2e-3), verbose=0,
    )
    op.fit_model(model, data)

    # the fast path must actually engage for this model shape
    module, params = model.model
    x = np.asarray(
        cp.mesh.all_index_coordinates(True, flatten=True)
    )
    import jax.numpy as jnp

    assert (
        _Op._build_hoisted_deeponet_apply(
            module, params, jnp.asarray(x), False, n_y
        )
        is not None
    )

    solution = op.solve(ivp).discrete_y()
    fn, _ = op.trajectory_function(cp, (0.0, 0.5))
    y_0 = np.asarray(ivp.initial_condition.discrete_y_0(True))
    rollout = np.asarray(jax.jit(fn)(y_0, 0.0))
    assert np.allclose(rollout, solution, atol=1e-8)


def test_trajectory_function_hoists_bare_deeponet():
    from pararealml_tpu.operators.ml import DeepONet

    np.random.seed(0)
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    n_y = int(np.prod(cp.y_shape(True)))
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.001
    )
    op = SupervisedMLOperator(0.25, True)
    model = SKLearnJaxRegressor(
        lambda: DeepONet(
            branch_net=FNN([8]),
            trunk_net=FNN([16, 8]),
            combiner_net=FNN([1]),
            branch_net_input_size=n_y,
        ),
        batch_size=64,
        epochs=20,
        verbose=0,
    )
    op.train(ivp, oracle, model, 3, lambda t, y: y * 1.01)

    solution = op.solve(ivp).discrete_y()
    fn, _ = op.trajectory_function(cp, (0.0, 0.5))
    y_0 = np.asarray(ivp.initial_condition.discrete_y_0(True))
    rollout = np.asarray(jax.jit(fn)(y_0, 0.0))
    assert np.allclose(rollout, solution, atol=1e-8)


def test_hoisted_deeponet_keeps_f32_carry_under_x64():
    # with x64 enabled the mesh coordinates are f64; an f32 state must
    # not be promoted by the hoisted path or the auto-regressive scan
    # carry changes dtype mid-loop
    from pararealml_tpu.operators.ml import DeepONet

    np.random.seed(0)
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    n_y = int(np.prod(cp.y_shape(True)))
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.001
    )
    op = SupervisedMLOperator(0.25, True)
    model = SKLearnJaxRegressor(
        lambda: DeepONet(
            branch_net=FNN([8]),
            trunk_net=FNN([8, 8]),
            combiner_net=FNN([1]),
            branch_net_input_size=n_y,
        ),
        batch_size=64,
        epochs=5,
        verbose=0,
    )
    op.train(ivp, oracle, model, 2, lambda t, y: y)
    fn, _ = op.trajectory_function(cp, (0.0, 0.5))
    y_0 = np.asarray(
        ivp.initial_condition.discrete_y_0(True), np.float32
    )
    rollout = jax.jit(fn)(y_0, np.float32(0.0))
    assert rollout.dtype == np.float32


def test_hoisting_guard_rejects_mismatched_branch_width():
    # a DeepONet whose branch consumes fewer features than the
    # flattened state must fall back to the generic tiled layout
    import jax.numpy as jnp

    from pararealml_tpu.operators.ml import DeepONet
    from pararealml_tpu.operators.ml.supervised.supervised_ml_operator import (  # noqa: E501
        SupervisedMLOperator as _Op,
    )

    module = DeepONet(
        branch_net=FNN([8]),
        trunk_net=FNN([8, 8]),
        combiner_net=FNN([1]),
        branch_net_input_size=3,
    )
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    x = jnp.zeros((4, 2))
    # state has 5 flattened features but the branch consumes 3
    assert (
        _Op._build_hoisted_deeponet_apply(module, params, x, False, 5)
        is None
    )


def test_generate_data_sharded_matches_single_device():
    """device_mesh shards the perturbed-IC batch over the 8-device mesh;
    with deterministic perturbations the generated dataset must be
    identical to the single-device batch (both modes)."""
    from pararealml_tpu.utils.distributed import space_mesh

    mesh = space_mesh(8, axis_names=("data",))

    def perturb(t, y):
        return y + 0.01 * np.sin(100.0 * y)

    for auto_regressive, time_variant in ((True, None), (False, True)):
        ivp = _diffusion_ivp()
        oracle = FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 0.025,
        )
        op = SupervisedMLOperator(
            0.1, True,
            auto_regressive=auto_regressive,
            time_variant=bool(time_variant),
        )
        single = op.generate_data(ivp, oracle, 8, perturb)
        sharded = op.generate_data(
            ivp, oracle, 8, perturb, device_mesh=mesh
        )
        np.testing.assert_allclose(
            sharded[0], single[0], rtol=0, atol=1e-12
        )
        np.testing.assert_allclose(
            sharded[1], single[1], rtol=0, atol=1e-12
        )

        # an indivisible iteration count silently runs unsharded
        uneven = op.generate_data(
            ivp, oracle, 3, perturb, device_mesh=mesh
        )
        assert len(uneven[0]) == len(single[0]) // 8 * 3


def test_time_parallel_affine_surrogate_takes_propagator_path():
    # a linear-branch/linear-combiner DeepONet is affine in the state,
    # so the parallel-in-time trajectory formulation probes (P, r) and
    # exposes the propagator surface Parareal's doubling sweeps consume;
    # the roll-out values must match the scan path
    import optax

    from pararealml_tpu.operators.ml import DeepONet, Standardized

    np.random.seed(0)
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    n_y = int(np.prod(cp.y_shape(True)))
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.001
    )
    op = SupervisedMLOperator(0.25, True)
    data = op.generate_data(ivp, oracle, 3, lambda t, y: y * 1.01)

    def build():
        return Standardized.from_data(
            DeepONet(
                branch_net=FNN([8], activation=lambda h: h),
                trunk_net=FNN([16, 8]),
                combiner_net=FNN([1], activation=lambda h: h),
                branch_net_input_size=n_y,
            ),
            *data,
        )

    model = SKLearnJaxRegressor(
        build, batch_size=64, epochs=5,
        optimizer=optax.adam(2e-3), verbose=0,
    )
    op.fit_model(model, data)

    scan_fn, t = op.trajectory_function(cp, (0.0, 0.75))
    prop_fn, t_prop = op.trajectory_function(
        cp, (0.0, 0.75), time_parallel=True
    )
    assert hasattr(prop_fn, "affine_slice_map")
    assert hasattr(prop_fn, "end_function")
    np.testing.assert_array_equal(t, t_prop)

    y_0 = np.asarray(ivp.initial_condition.discrete_y_0(True))
    scan_ys = np.asarray(jax.jit(scan_fn)(y_0, 0.0))
    prop_ys = np.asarray(jax.jit(prop_fn)(y_0, 0.0))
    scale = max(1.0, float(np.abs(scan_ys).max()))
    assert np.max(np.abs(prop_ys - scan_ys)) / scale < 1e-6


def test_time_parallel_nonlinear_surrogate_keeps_scan_rollout():
    # a tanh-branch surrogate fails the affinity probe and must fall
    # back to the scan roll-out silently
    import optax

    np.random.seed(0)
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.001
    )
    op = SupervisedMLOperator(0.25, True)
    data = op.generate_data(ivp, oracle, 3, lambda t, y: y * 1.01)
    model = SKLearnJaxRegressor(
        lambda: FNN([32, data[1].shape[-1]]),
        batch_size=64, epochs=5,
        optimizer=optax.adam(2e-3), verbose=0,
    )
    op.fit_model(model, data)

    prop_fn, _ = op.trajectory_function(
        cp, (0.0, 0.75), time_parallel=True
    )
    assert not hasattr(prop_fn, "affine_slice_map")
    scan_fn, _ = op.trajectory_function(cp, (0.0, 0.75))
    y_0 = np.asarray(ivp.initial_condition.discrete_y_0(True))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(prop_fn)(y_0, 0.0)),
        np.asarray(jax.jit(scan_fn)(y_0, 0.0)),
    )


def test_ends_function_matches_trajectory_last_frame():
    # carry-only ends must be bit-identical to the scan roll-out's
    # final frame (auto-regressive) / final prediction (time-variant)
    import optax

    np.random.seed(0)
    ivp = _diffusion_ivp()
    cp = ivp.constrained_problem
    oracle = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.001
    )
    y_0 = np.asarray(ivp.initial_condition.discrete_y_0(True))

    for kwargs in (
        dict(auto_regressive=True),
        dict(auto_regressive=False, time_variant=True),
    ):
        op = SupervisedMLOperator(0.25, True, **kwargs)
        data = op.generate_data(
            ivp, oracle, 3, lambda t, y: y * 1.01
        )
        model = SKLearnJaxRegressor(
            lambda: FNN([16, data[1].shape[-1]]),
            batch_size=64, epochs=5,
            optimizer=optax.adam(2e-3), verbose=0,
        )
        op.fit_model(model, data)

        fn, _ = op.trajectory_function(cp, (0.0, 0.75))
        ends = op.ends_function(cp, (0.0, 0.75))
        batched = jax.vmap(ends, in_axes=(0, None))(
            np.stack([y_0, y_0]), 0.0
        )
        np.testing.assert_allclose(
            np.asarray(batched)[1], np.asarray(jax.jit(ends)(y_0, 0.0))
        )
        np.testing.assert_array_equal(
            np.asarray(jax.jit(ends)(y_0, 0.0)),
            np.asarray(jax.jit(fn)(y_0, 0.0))[-1],
        )
