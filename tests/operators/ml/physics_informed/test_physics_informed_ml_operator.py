import jax
import numpy as np
import optax
import pytest

from pararealml_tpu import (
    ConstrainedProblem,
    ContinuousInitialCondition,
    DiffusionEquation,
    DirichletBoundaryCondition,
    InitialValueProblem,
    Mesh,
    PopulationGrowthEquation,
)
from pararealml_tpu.operators.ml.physics_informed import (
    DataArgs,
    DeepONet,
    FNN,
    ModelArgs,
    OptimizationArgs,
    PhysicsInformedMLOperator,
    PhysicsInformedRegressor,
    UniformRandomCollocationPointSampler,
)

SAMPLER = UniformRandomCollocationPointSampler()


def _population_growth_setup():
    r = 1.0
    cp = ConstrainedProblem(PopulationGrowthEquation(r))
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([32, 16]),
            trunk_net=FNN([32, 16]),
            combiner_net=FNN([32, 1]),
            branch_net_input_size=1,
        )
    )
    data_args = DataArgs(
        y_0_functions=[lambda _: np.array([1.0])],
        n_domain_points=160,
        n_batches=1,
    )
    return cp, model_args, data_args


def test_train_requires_model_args_for_fresh_operator():
    cp, _, data_args = _population_growth_setup()
    operator = PhysicsInformedMLOperator(SAMPLER, 0.1, True)
    with pytest.raises(ValueError):
        operator.train(
            cp,
            (0.0, 1.0),
            data_args,
            OptimizationArgs(optimizer="adam", epochs=1, verbose=0),
        )


def test_solve_requires_trained_model():
    cp, _, _ = _population_growth_setup()
    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    with pytest.raises(ValueError):
        PhysicsInformedMLOperator(SAMPLER, 0.1, True).solve(ivp)


def test_auto_regressive_validity_checks():
    operator = PhysicsInformedMLOperator(
        SAMPLER, 0.1, True, auto_regressive=True
    )
    cp, model_args, data_args = _population_growth_setup()
    opt_args = OptimizationArgs(optimizer="adam", epochs=1, verbose=0)

    # time interval must be (0, d_t)
    with pytest.raises(ValueError):
        operator.train(cp, (0.0, 1.0), data_args, opt_args, model_args)

    # dynamic BCs are rejected
    mesh = Mesh([(0.0, 1.0)], [0.5])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), 1), t)
    )
    dynamic_cp = ConstrainedProblem(
        DiffusionEquation(1), mesh, [(bc, bc)]
    )
    pde_data_args = DataArgs(
        y_0_functions=[lambda x: np.zeros_like(x)],
        n_domain_points=9,
        n_batches=1,
        n_boundary_points=3,
    )
    with pytest.raises(ValueError):
        operator.train(
            dynamic_cp, (0.0, 0.1), pde_data_args, opt_args, model_args
        )


@pytest.mark.slow
def test_population_growth_matches_analytic_solution():
    np.random.seed(0)
    cp, model_args, data_args = _population_growth_setup()
    operator = PhysicsInformedMLOperator(SAMPLER, 0.1, True)
    history, test_metrics = operator.train(
        cp,
        (0.0, 1.0),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=500, verbose=0
        ),
        model_args,
        test_data_args=data_args,
    )
    assert history["loss"][-1] < 1e-3
    assert test_metrics is not None and "loss" in test_metrics

    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    solution = operator.solve(ivp)
    exact = np.exp(solution.t_coordinates)
    assert np.abs(solution.discrete_y()[:, 0] - exact).max() < 0.01


def test_pde_training_with_boundary_conditions():
    np.random.seed(1)
    mesh = Mesh([(0.0, 1.0)], [0.1])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.2), mesh, [(bc, bc)])

    operator = PhysicsInformedMLOperator(SAMPLER, 0.05, True)
    data_args = DataArgs(
        y_0_functions=[lambda x: np.sin(np.pi * x)],
        n_domain_points=100,
        n_boundary_points=20,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([32, 16]),
            trunk_net=FNN([32, 16]),
            combiner_net=FNN([32, 1]),
            branch_net_input_size=11,
        ),
        ic_loss_weight=10.0,
        bc_loss_weight=10.0,
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.5),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=600, verbose=0, seed=1
        ),
        model_args,
    )
    assert history["loss"][-1] < 5e-3
    assert "dirichlet_bc_loss" in history

    ic = ContinuousInitialCondition(cp, lambda x: np.sin(np.pi * x))
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)
    solution = operator.solve(ivp)
    x = mesh.vertex_axis_coordinates[0]
    exact = np.exp(
        -0.2 * np.pi**2 * solution.t_coordinates[:, None]
    ) * np.sin(np.pi * x)[None, :]
    assert np.abs(solution.discrete_y()[..., 0] - exact).max() < 0.05


def test_trajectory_function_matches_solve():
    np.random.seed(0)
    cp, model_args, data_args = _population_growth_setup()
    operator = PhysicsInformedMLOperator(SAMPLER, 0.2, True)
    operator.train(
        cp,
        (0.0, 1.0),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=50, verbose=0
        ),
        model_args,
    )
    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    solution = operator.solve(ivp).discrete_y()

    fn, t = operator.trajectory_function(cp, (0.0, 1.0))
    rollout = np.asarray(jax.jit(fn)(np.array([1.0]), 0.0))
    assert np.allclose(rollout, solution, atol=1e-6)

    # the carry-only ends roll-out (Parareal's correction-iteration
    # consumer) must be bit-identical to the trajectory's final frame
    ends = operator.ends_function(cp, (0.0, 1.0))
    batched = jax.vmap(ends, in_axes=(0, None))(
        np.array([[1.0], [1.0]]), 0.0
    )
    np.testing.assert_allclose(np.asarray(batched)[1], rollout[-1])
    np.testing.assert_array_equal(
        np.asarray(jax.jit(ends)(np.array([1.0]), 0.0)),
        rollout[-1],
    )


@pytest.mark.slow
def test_validation_history_and_retraining():
    np.random.seed(0)
    cp, model_args, data_args = _population_growth_setup()
    operator = PhysicsInformedMLOperator(SAMPLER, 0.1, True)
    history, _ = operator.train(
        cp,
        (0.0, 1.0),
        data_args,
        OptimizationArgs(
            optimizer="adam",
            epochs=4,
            validation_frequency=2,
            verbose=0,
        ),
        model_args,
        validation_data_args=data_args,
    )
    assert len(history["loss"]) == 4
    assert len(history["val_loss"]) == 2

    # continued training without model args reuses the stored model
    history_2, _ = operator.train(
        cp,
        (0.0, 1.0),
        data_args,
        OptimizationArgs(optimizer="adam", epochs=2, verbose=0),
    )
    assert len(history_2["loss"]) == 2


def test_regressor_loss_weights_validation():
    cp, model_args, _ = _population_growth_setup()
    with pytest.raises(ValueError):
        PhysicsInformedRegressor(
            model=model_args.model, cp=cp, diff_eq_loss_weight=[1.0, 2.0]
        )


def test_pinn_coarse_operator_inside_parareal():
    """The north-star composition: a trained physics-informed surrogate
    as the coarse operator inside the fully compiled Parareal."""
    from pararealml_tpu.operators.ode import ODEOperator
    from pararealml_tpu.operators.parareal import PararealOperator

    np.random.seed(0)
    r = 1.0
    cp = ConstrainedProblem(PopulationGrowthEquation(r))
    operator = PhysicsInformedMLOperator(
        SAMPLER, 0.25, True, auto_regressive=True
    )
    training_y_0_functions = [
        lambda _, _y_0=y_0: np.array([_y_0])
        for y_0 in np.arange(0.5, 3.5, 0.25)
    ]
    operator.train(
        cp,
        (0.0, 0.25),
        DataArgs(
            y_0_functions=training_y_0_functions,
            n_domain_points=50,
            n_batches=1,
        ),
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=400, verbose=0
        ),
        ModelArgs(
            model=DeepONet(
                branch_net=FNN([32, 16]),
                trunk_net=FNN([32, 16]),
                combiner_net=FNN([32, 1]),
                branch_net_input_size=1,
            )
        ),
    )

    fine = ODEOperator("RK45", 0.005, rtol=1e-10, atol=1e-13)
    parareal = PararealOperator(
        fine, operator, 1e-9, num_time_slices=8
    )
    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 2.0), ic)
    fine_y = fine.solve(ivp).discrete_y()
    parareal_y = parareal.solve(ivp).discrete_y()
    assert np.allclose(parareal_y, fine_y, atol=1e-5)


def test_ode_system_training_lotka_volterra():
    # coupled two-component ODE system trained through the PINN path
    from pararealml_tpu import LotkaVolterraEquation

    np.random.seed(2)
    cp = ConstrainedProblem(LotkaVolterraEquation(2.0, 1.0, 0.8, 1.0))
    operator = PhysicsInformedMLOperator(SAMPLER, 0.05, True)
    data_args = DataArgs(
        y_0_functions=[lambda _: np.array([1.0, 0.5])],
        n_domain_points=120,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([32, 16]),
            trunk_net=FNN([32, 16]),
            combiner_net=FNN([32, 2]),
            branch_net_input_size=2,
        ),
        ic_loss_weight=10.0,
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.5),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=500, verbose=0, seed=2
        ),
        model_args,
    )
    assert history["loss"][-1] < history["loss"][0]
    assert history["loss"][-1] < 1e-2

    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0, 0.5]))
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)
    y = operator.solve(ivp).discrete_y()
    # cross-check against the jitted adaptive RK solution
    from pararealml_tpu.operators.ode import ODEOperator

    reference = ODEOperator(
        "RK45", 0.05, rtol=1e-10, atol=1e-12
    ).solve(ivp).discrete_y()
    assert np.abs(y - reference).max() < 0.05


@pytest.mark.slow
def test_polar_pde_training_smoke():
    # the curvilinear PINN path (symbol mapper -> batched polar
    # operators) must train stably end to end
    from pararealml_tpu import CoordinateSystem, NeumannBoundaryCondition

    np.random.seed(3)
    mesh = Mesh(
        [(1.0, 2.0), (0.0, np.pi)],
        [0.25, np.pi / 4],
        CoordinateSystem.POLAR,
    )
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(DiffusionEquation(2, 0.1), mesh, [(bc, bc)] * 2)
    operator = PhysicsInformedMLOperator(SAMPLER, 0.05, True)
    data_args = DataArgs(
        y_0_functions=[lambda x: np.ones((len(x), 1))],
        n_domain_points=60,
        n_boundary_points=12,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([16, 8]),
            trunk_net=FNN([16, 8]),
            combiner_net=FNN([16, 1]),
            branch_net_input_size=np.prod(cp.y_shape(True)).item(),
        )
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.2),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=60, verbose=0, seed=3
        ),
        model_args,
    )
    losses = np.asarray(history["loss"])
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_auto_regressive_rejects_t_dependent_rhs():
    from pararealml_tpu import DifferentialEquation, SymbolicEquationSystem

    class DrivenODE(DifferentialEquation):
        def __init__(self):
            super().__init__(0, 1)

        @property
        def symbolic_equation_system(self):
            return SymbolicEquationSystem([self._symbols.t])

    operator = PhysicsInformedMLOperator(
        SAMPLER, 0.1, True, auto_regressive=True
    )
    cp = ConstrainedProblem(DrivenODE())
    data_args = DataArgs(
        y_0_functions=[lambda _: np.array([1.0])],
        n_domain_points=8,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([8]),
            trunk_net=FNN([8]),
            combiner_net=FNN([8, 1]),
            branch_net_input_size=1,
        )
    )
    with pytest.raises(ValueError):
        operator.train(
            cp,
            (0.0, 0.1),
            data_args,
            OptimizationArgs(optimizer="adam", epochs=1, verbose=0),
            model_args,
        )


@pytest.mark.slow
def test_auto_regressive_ode_end_to_end():
    # AR mode trains on one (0, d_t) step from varied initial states and
    # rolls the model forward autoregressively at solve time
    np.random.seed(5)
    r = 1.0
    cp = ConstrainedProblem(PopulationGrowthEquation(r))
    operator = PhysicsInformedMLOperator(
        SAMPLER, 0.1, True, auto_regressive=True
    )
    data_args = DataArgs(
        y_0_functions=[
            (lambda v: lambda _: np.array([v]))(v)
            for v in np.linspace(0.5, 2.0, 16)
        ],
        n_domain_points=40,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([32, 16]),
            trunk_net=FNN([32, 16]),
            combiner_net=FNN([32, 1]),
            branch_net_input_size=1,
        )
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.1),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=800, verbose=0, seed=5
        ),
        model_args,
    )
    assert history["loss"][-1] < 1e-3

    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 0.5), ic)
    solution = operator.solve(ivp)
    exact = np.exp(solution.t_coordinates)
    # error compounds across the 5 autoregressive steps
    assert np.abs(solution.discrete_y()[:, 0] - exact).max() < 0.05


@pytest.mark.slow
def test_auto_regressive_pde_smoke():
    np.random.seed(6)
    mesh = Mesh([(0.0, 1.0)], [0.2])
    bc = DirichletBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(DiffusionEquation(1, 0.2), mesh, [(bc, bc)])
    operator = PhysicsInformedMLOperator(
        SAMPLER, 0.05, True, auto_regressive=True
    )
    data_args = DataArgs(
        y_0_functions=[
            (lambda a: lambda x: a * np.sin(np.pi * x))(a)
            for a in np.linspace(0.5, 1.5, 4)
        ],
        n_domain_points=40,
        n_boundary_points=8,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([16, 8]),
            trunk_net=FNN([16, 8]),
            combiner_net=FNN([16, 1]),
            branch_net_input_size=6,
        ),
        ic_loss_weight=10.0,
        bc_loss_weight=10.0,
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.05),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=80, verbose=0, seed=6
        ),
        model_args,
    )
    losses = np.asarray(history["loss"])
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]

    ic = ContinuousInitialCondition(cp, lambda x: np.sin(np.pi * x))
    ivp = InitialValueProblem(cp, (0.0, 0.2), ic)
    y = operator.solve(ivp).discrete_y()
    assert y.shape == (4, 6, 1)
    assert np.all(np.isfinite(y))


@pytest.mark.slow
def test_cylindrical_pde_training_smoke():
    from pararealml_tpu import CoordinateSystem, NeumannBoundaryCondition

    np.random.seed(7)
    mesh = Mesh(
        [(1.0, 2.0), (0.0, np.pi), (0.0, 1.0)],
        [0.5, np.pi / 2, 0.5],
        CoordinateSystem.CYLINDRICAL,
    )
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(
        DiffusionEquation(3, 0.1), mesh, [(bc, bc)] * 3
    )
    operator = PhysicsInformedMLOperator(SAMPLER, 0.05, True)
    data_args = DataArgs(
        y_0_functions=[lambda x: np.ones((len(x), 1))],
        n_domain_points=40,
        n_boundary_points=8,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([16, 8]),
            trunk_net=FNN([16, 8]),
            combiner_net=FNN([16, 1]),
            branch_net_input_size=np.prod(cp.y_shape(True)).item(),
        )
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.2),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=40, verbose=0, seed=7
        ),
        model_args,
    )
    losses = np.asarray(history["loss"])
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_spherical_pde_training_smoke():
    from pararealml_tpu import CoordinateSystem, NeumannBoundaryCondition

    np.random.seed(8)
    mesh = Mesh(
        [(1.0, 2.0), (0.0, np.pi), (0.25 * np.pi, 0.75 * np.pi)],
        [0.5, np.pi / 2, np.pi / 4],
        CoordinateSystem.SPHERICAL,
    )
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = ConstrainedProblem(
        DiffusionEquation(3, 0.1), mesh, [(bc, bc)] * 3
    )
    operator = PhysicsInformedMLOperator(SAMPLER, 0.05, True)
    data_args = DataArgs(
        y_0_functions=[lambda x: np.ones((len(x), 1))],
        n_domain_points=40,
        n_boundary_points=8,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([16, 8]),
            trunk_net=FNN([16, 8]),
            combiner_net=FNN([16, 1]),
            branch_net_input_size=np.prod(cp.y_shape(True)).item(),
        )
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.2),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=40, verbose=0, seed=8
        ),
        model_args,
    )
    losses = np.asarray(history["loss"])
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_pde_system_training_smoke():
    # multi-component PDE (1D wave): per-equation loss terms must all
    # appear in the history and train stably
    from pararealml_tpu import NeumannBoundaryCondition, WaveEquation

    np.random.seed(9)
    mesh = Mesh([(0.0, 1.0)], [0.2])
    bc = NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = ConstrainedProblem(WaveEquation(1, 0.5), mesh, [(bc, bc)])
    operator = PhysicsInformedMLOperator(SAMPLER, 0.05, True)
    data_args = DataArgs(
        y_0_functions=[
            lambda x: np.concatenate(
                [np.sin(np.pi * x), np.zeros_like(x)], axis=-1
            )
        ],
        n_domain_points=40,
        n_boundary_points=8,
        n_batches=1,
    )
    model_args = ModelArgs(
        model=DeepONet(
            branch_net=FNN([16, 8]),
            trunk_net=FNN([16, 8]),
            combiner_net=FNN([16, 2]),
            branch_net_input_size=np.prod(cp.y_shape(True)).item(),
        )
    )
    history, _ = operator.train(
        cp,
        (0.0, 0.2),
        data_args,
        OptimizationArgs(
            optimizer=optax.adam(3e-3), epochs=40, verbose=0, seed=9
        ),
        model_args,
    )
    losses = np.asarray(history["loss"])
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_data_parallel_training_matches_single_device():
    """OptimizationArgs(device_mesh=...) shards collocation batches
    over the 8-device mesh with replicated parameters; with the same
    seed it must reproduce the single-device training losses up to
    collective reduction reordering."""
    from pararealml_tpu.utils.distributed import space_mesh

    def run(device_mesh):
        # the sampler draws from NumPy's global RNG; pin it so both
        # runs train on identical collocation points
        np.random.seed(123)
        cp, model_args, data_args = _population_growth_setup()
        operator = PhysicsInformedMLOperator(SAMPLER, 0.1, True)
        history, _ = operator.train(
            cp,
            (0.0, 1.0),
            data_args,
            OptimizationArgs(
                optimizer=optax.adam(1e-3),
                epochs=15,
                verbose=0,
                seed=4,
                device_mesh=device_mesh,
            ),
            model_args,
        )
        return history

    single = run(None)
    parallel = run(space_mesh(8, axis_names=("data",)))
    np.testing.assert_allclose(
        parallel["loss"], single["loss"], rtol=1e-4
    )


def test_epoch_block_path_matches_per_epoch_path():
    """Without per-epoch host observers, whole blocks of epochs run as
    one compiled scan; adding a callback forces the per-epoch path.
    With pinned data and parameter seeds, both must produce the same
    training history, and the callback must fire once per epoch."""

    def run(callbacks):
        np.random.seed(42)
        cp, model_args, data_args = _population_growth_setup()
        operator = PhysicsInformedMLOperator(SAMPLER, 0.1, True)
        history, _ = operator.train(
            cp,
            (0.0, 1.0),
            data_args,
            OptimizationArgs(
                optimizer=optax.adam(1e-3),
                epochs=6,
                verbose=0,
                seed=11,
                callbacks=callbacks,
            ),
            model_args,
        )
        return history

    blocked = run(())
    seen = []
    per_epoch = run([lambda epoch, logs: seen.append(epoch)])
    assert seen == list(range(6))
    assert len(blocked["loss"]) == 6
    np.testing.assert_allclose(
        blocked["loss"], per_epoch["loss"], rtol=1e-6
    )


@pytest.mark.slow
def test_reference_scale_trained_asset_solution_error():
    """The committed 5000-epoch training asset (the reference example's
    budget, /root/reference/examples/
    diffusion_1d_physics_informed_ml.py:77, regenerated by
    .scratch/train_pinn_asset.py) solves the diffusion_1d problem to
    small error against an FDM fine solve — the PINN QUALITY loop, not
    just training throughput."""
    import os

    from pararealml_tpu import (
        DiffusionEquation,
        InitialValueProblem,
        MarginalBetaProductInitialCondition,
        Mesh,
        NeumannBoundaryCondition,
    )
    from pararealml_tpu.operators.fdm import (
        CrankNicolsonMethod,
        FDMOperator,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu.operators.ml import DeepONet, FNN
    from pararealml_tpu.operators.ml.physics_informed import (
        PhysicsInformedRegressor,
    )
    from pararealml_tpu.utils.checkpoint import load_pytree

    asset = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "..", "..", "..", "bench_assets",
        "pinn_diffusion_1d.msgpack",
    )
    if not os.path.exists(asset):
        pytest.skip("trained PINN asset not present")

    diff_eq = DiffusionEquation(1, 0.2)
    mesh = Mesh([(0.0, 1.0)], (0.1,))
    bcs = [
        (
            NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        )
        * 2
    ]
    cp = ConstrainedProblem(diff_eq, mesh, bcs)
    t_interval = (0.0, 0.5)
    regressor = PhysicsInformedRegressor(
        model=DeepONet(
            branch_net=FNN([50] * 8),
            trunk_net=FNN([50] * 8),
            combiner_net=FNN([diff_eq.y_dimension]),
            branch_net_input_size=int(np.prod(cp.y_vertices_shape)),
        ),
        cp=cp,
        ic_loss_weight=10.0,
        vertex_oriented=True,
    )
    import jax.numpy as jnp

    template = {
        "params": regressor.init_params(jax.random.PRNGKey(0)),
        "final_loss": jnp.zeros((), jnp.float32),
        "epochs": jnp.zeros((), jnp.int32),
    }
    saved = load_pytree(asset, template)
    regressor.params = saved["params"]
    assert int(saved["epochs"]) >= 5000
    piml = PhysicsInformedMLOperator(
        UniformRandomCollocationPointSampler(), 0.001, True
    )
    piml.model = regressor

    fdm = FDMOperator(
        CrankNicolsonMethod(), ThreePointCentralDifferenceMethod(), 1e-4
    )
    ic = MarginalBetaProductInitialCondition(cp, [[(3.5, 3.5)]])
    ivp = InitialValueProblem(cp, t_interval, ic)
    fdm_y = fdm.solve(ivp).discrete_y(True)
    piml_y = piml.solve(ivp).discrete_y(True)
    stride = len(fdm_y) // len(piml_y)
    err = float(np.max(np.abs(piml_y - fdm_y[stride - 1 :: stride])))
    # solution peak is ~2.2 (a Beta(3.5, 3.5) pdf diffusing); the
    # committed 5000-epoch asset lands at 6.8e-2 max error over the
    # 500-step auto-regressive roll-out (~3% of peak) — the bound
    # guards against regressions of that measured quality
    assert err < 0.08
