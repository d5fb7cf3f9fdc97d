"""The physics-informed ML operator.

Capability match for /root/reference/pararealml/operators/ml/
physics_informed/physics_informed_ml_operator.py:35-331: training a
physics-informed regressor over variable initial conditions
(``DataArgs``/``ModelArgs``/``OptimizationArgs`` bundles, validation and
test sets, auto-regressive-mode validity checks) and roll-out inference.

The Keras ``fit`` generator loop becomes a jitted ``lax.scan`` over the
stacked batches of each epoch — one device dispatch per epoch — driven
by optax. A trained operator also exposes ``trajectory_function`` (the
roll-out as a pure ``lax.scan``), so physics-informed surrogates can act
as coarse operators inside the compiled shard_map Parareal.
"""

from __future__ import annotations

from typing import (
    Any,
    Dict,
    Iterable,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from pararealml_tpu.constrained_problem import ConstrainedProblem
from pararealml_tpu.initial_condition import (
    VectorizedInitialConditionFunction,
)
from pararealml_tpu.initial_value_problem import (
    InitialValueProblem,
    TemporalDomainInterval,
)
from pararealml_tpu.operator import JaxOperator, discretize_time_domain
from pararealml_tpu.operators.ml.physics_informed.\
    collocation_point_sampler import CollocationPointSampler
from pararealml_tpu.operators.ml.physics_informed.dataset import Dataset
from pararealml_tpu.operators.ml.physics_informed.\
    physics_informed_regressor import PhysicsInformedRegressor
from pararealml_tpu.solution import Solution


class DataArgs(NamedTuple):
    """Arguments for physics-informed dataset generation."""

    y_0_functions: Iterable[VectorizedInitialConditionFunction]
    n_domain_points: int
    n_batches: int
    n_boundary_points: int = 0
    n_ic_repeats: int = 1
    shuffle: bool = True


class ModelArgs(NamedTuple):
    """Arguments for the physics-informed regression model."""

    model: nn.Module
    diff_eq_loss_weight: Union[float, Sequence[float]] = 1.0
    ic_loss_weight: Union[float, Sequence[float]] = 1.0
    bc_loss_weight: Union[float, Sequence[float]] = 1.0


class OptimizationArgs(NamedTuple):
    """Arguments for training the physics-informed model.

    ``device_mesh`` enables data-parallel training over a
    ``jax.sharding.Mesh``: collocation batches shard over the mesh's
    first axis (any batch whose size does not divide the device count
    stays replicated), parameters and optimizer state stay replicated,
    and the gradient all-reduces are inserted by XLA's SPMD
    partitioner. The reference trains on a single GPU.
    """

    optimizer: Union[str, Dict[str, Any], optax.GradientTransformation]
    epochs: int
    validation_frequency: int = 1
    callbacks: Sequence = ()
    verbose: Union[str, int] = "auto"
    seed: int = 0
    device_mesh: Optional[Any] = None


def _resolve_optimizer(optimizer) -> optax.GradientTransformation:
    if isinstance(optimizer, str):
        return getattr(optax, optimizer.lower())(1e-3)
    if isinstance(optimizer, dict):
        config = dict(optimizer)
        name = config.pop("class_name", None) or config.pop("name")
        kwargs = config.pop("config", config)
        return getattr(optax, name.lower())(**kwargs)
    return optimizer


class PhysicsInformedMLOperator(JaxOperator):
    """An operator solving IVPs with a trained physics-informed model."""

    def __init__(
        self,
        sampler: CollocationPointSampler,
        d_t: float,
        vertex_oriented: bool,
        auto_regressive: bool = False,
    ):
        super().__init__(d_t, vertex_oriented)
        self._sampler = sampler
        self._auto_regressive = auto_regressive
        self._model: Optional[PhysicsInformedRegressor] = None
        # single-slot cache of the jitted training programs, keyed on
        # (model, optimizer, data signature); see train()
        self._train_programs: Optional[dict] = None

    @property
    def auto_regressive(self) -> bool:
        """Whether inference feeds predictions back as initial
        conditions."""
        return self._auto_regressive

    @property
    def model(self) -> Optional[PhysicsInformedRegressor]:
        """The physics-informed regression model behind the operator."""
        return self._model

    @model.setter
    def model(self, model: Optional[PhysicsInformedRegressor]):
        self._model = model

    # -- inference ---------------------------------------------------------

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        if self._model is None or self._model.params is None:
            raise ValueError("operator has no trained model")

        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        t = discretize_time_domain(ivp.t_interval, self._d_t)[1:]
        y_shape = tuple(cp.y_shape(self._vertex_oriented))

        if diff_eq.x_dimension:
            x = jnp.asarray(
                cp.mesh.all_index_coordinates(
                    self._vertex_oriented, flatten=True
                )
            )
            u_row = ivp.initial_condition.y_0(
                np.asarray(x)
            ).reshape(1, -1)
            u = jnp.tile(jnp.asarray(u_row), (len(x), 1))
        else:
            x = None
            u = jnp.asarray([ivp.initial_condition.y_0(None)])

        model = self._model
        params = model.params
        infer = jax.jit(
            lambda params, u, t_col, x: model.apply(params, u, t_col, x)
        )

        n_rows = u.shape[0]
        y = np.empty((len(t),) + y_shape)
        for i, t_i in enumerate(t):
            t_value = self._d_t if self._auto_regressive else t_i
            t_col = jnp.full((n_rows, 1), t_value, u.dtype)
            y_i = infer(params, u, t_col, x)
            y[i] = np.asarray(y_i).reshape(y_shape)
            if i < len(t) - 1 and self._auto_regressive:
                u = (
                    jnp.tile(y_i.reshape(1, -1), (n_rows, 1))
                    if diff_eq.x_dimension
                    else y_i.reshape(u.shape)
                )

        return Solution(
            ivp,
            t,
            y,
            vertex_oriented=self._vertex_oriented,
            d_t=self._d_t,
        )

    def trajectory_function(
        self, cp, t_interval, time_parallel=False
    ):
        """A pure jittable roll-out of the trained model over the time
        grid."""
        if self._model is None or self._model.params is None:
            raise ValueError("operator has no trained model")
        model = self._model
        params = model.params
        diff_eq = cp.differential_equation
        y_shape = tuple(cp.y_shape(self._vertex_oriented))
        t = discretize_time_domain(t_interval, self._d_t)
        t_offsets = jnp.asarray(t[1:] - t[0])

        if diff_eq.x_dimension:
            x = jnp.asarray(
                cp.mesh.all_index_coordinates(
                    self._vertex_oriented, flatten=True
                )
            )
            n_rows = len(x)
        else:
            x = None
            n_rows = 1

        auto_regressive = self._auto_regressive
        d_t = self._d_t

        def trajectory(y_0, t_0):
            u_0 = jnp.ravel(y_0)

            def step(u_flat, t_offset):
                u = jnp.tile(u_flat[jnp.newaxis], (n_rows, 1))
                t_value = d_t if auto_regressive else t_0 + t_offset
                t_col = jnp.full((n_rows, 1), t_value, u.dtype)
                prediction = model.apply(params, u, t_col, x)
                next_u = (
                    jnp.ravel(prediction) if auto_regressive else u_flat
                )
                return next_u, prediction.reshape(y_shape)

            _, ys = jax.lax.scan(step, u_0, t_offsets)
            return ys

        return trajectory, t[1:]

    def ends_function(self, cp, t_interval):
        """The carry-only counterpart of :meth:`trajectory_function`:
        ``fn(y_0, t_0) -> y_end`` without stacking per-step
        predictions, for consumers that need only end states —
        Parareal's correction iterations with a physics-informed
        coarse operator (the reference likewise discards slice
        interiors, /root/reference/pararealml/operators/parareal/
        parareal_operator.py:163-185)."""
        if self._model is None or self._model.params is None:
            raise ValueError("operator has no trained model")
        model = self._model
        params = model.params
        diff_eq = cp.differential_equation
        y_shape = tuple(cp.y_shape(self._vertex_oriented))
        t = discretize_time_domain(t_interval, self._d_t)
        t_offsets = jnp.asarray(t[1:] - t[0])

        if diff_eq.x_dimension:
            x = jnp.asarray(
                cp.mesh.all_index_coordinates(
                    self._vertex_oriented, flatten=True
                )
            )
            n_rows = len(x)
        else:
            x = None
            n_rows = 1

        auto_regressive = self._auto_regressive
        d_t = self._d_t

        def predict(u_flat, t_value, dtype):
            u = jnp.tile(u_flat[jnp.newaxis], (n_rows, 1))
            t_col = jnp.full((n_rows, 1), t_value, dtype)
            return model.apply(params, u, t_col, x)

        def ends(y_0, t_0):
            u_0 = jnp.ravel(y_0)
            if not auto_regressive:
                # direct-t inference: only the final time matters
                return predict(
                    u_0, t_0 + t_offsets[-1], u_0.dtype
                ).reshape(y_shape)

            def step(u_flat, t_offset):
                prediction = predict(u_flat, d_t, u_flat.dtype)
                return jnp.ravel(prediction), None

            last, _ = jax.lax.scan(step, u_0, t_offsets)
            return last.reshape(y_shape)

        return ends

    # -- training ----------------------------------------------------------

    def train(
        self,
        cp: ConstrainedProblem,
        t_interval: TemporalDomainInterval,
        training_data_args: DataArgs,
        optimization_args: OptimizationArgs,
        model_args: Optional[ModelArgs] = None,
        validation_data_args: Optional[DataArgs] = None,
        test_data_args: Optional[DataArgs] = None,
    ) -> Tuple[Dict[str, list], Optional[Dict[str, float]]]:
        """Trains (and stores) a physics-informed regressor; returns the
        training history and, if a test set is given, the test metrics."""
        if model_args is None and self._model is None:
            raise ValueError(
                "the model arguments cannot be None if the operator's "
                "model is None"
            )

        if self._auto_regressive:
            self._validate_auto_regressive_mode(cp, t_interval)

        training_iterator = self._create_iterator(
            cp, t_interval, training_data_args
        )
        validation_iterator = self._create_iterator(
            cp, t_interval, validation_data_args
        )
        test_iterator = self._create_iterator(
            cp, t_interval, test_data_args
        )

        model = (
            self._model
            if model_args is None
            else PhysicsInformedRegressor(
                model=model_args.model,
                cp=cp,
                diff_eq_loss_weight=model_args.diff_eq_loss_weight,
                ic_loss_weight=model_args.ic_loss_weight,
                bc_loss_weight=model_args.bc_loss_weight,
                vertex_oriented=self._vertex_oriented,
            )
        )
        if model.params is None:
            model.init_params(
                jax.random.PRNGKey(optimization_args.seed)
            )

        optimizer = _resolve_optimizer(optimization_args.optimizer)
        opt_state = optimizer.init(model.params)

        mesh = optimization_args.device_mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            data_axis = mesh.axis_names[0]
            n_data_shards = mesh.shape[data_axis]
            replicated = NamedSharding(mesh, PartitionSpec())
            batch_sharding = NamedSharding(
                mesh, PartitionSpec(None, data_axis)
            )

            def shard_stacked(stacked, batch_axis=1):
                # (n_batches, batch_size, ...) leaves — or, for an
                # epoch block, (epochs, n_batches, batch_size, ...) —
                # shard over the per-step batch axis; batches whose
                # size does not divide the device count stay
                # replicated (GSPMD requires even splits)
                def place(leaf):
                    leaf = jnp.asarray(leaf)
                    if (
                        leaf.ndim > batch_axis
                        and leaf.shape[batch_axis] % n_data_shards
                        == 0
                    ):
                        if batch_axis == 1:
                            return jax.device_put(
                                leaf, batch_sharding
                            )
                        spec = [None] * (batch_axis + 1)
                        spec[batch_axis] = data_axis
                        return jax.device_put(
                            leaf,
                            NamedSharding(
                                mesh, PartitionSpec(*spec)
                            ),
                        )
                    return jax.device_put(leaf, replicated)

                return jax.tree_util.tree_map(place, stacked)

        else:

            def shard_stacked(stacked, batch_axis=1):
                return stacked

        def loss_fn(params, domain_batch, initial_batch, boundary_batch):
            loss, metrics = model.compute_batch_loss(
                params, domain_batch, initial_batch, boundary_batch
            )
            return loss, metrics

        def train_epoch(params, opt_state, stacked):
            domain, initial, boundary = stacked

            def step(carry, batch):
                params, opt_state = carry
                domain_batch, initial_batch, boundary_batch = batch
                (_, metrics), grads = jax.value_and_grad(
                    loss_fn, has_aux=True
                )(params, domain_batch, initial_batch, boundary_batch)
                updates, opt_state = optimizer.update(
                    grads, opt_state, params
                )
                params = optax.apply_updates(params, updates)
                return (params, opt_state), metrics

            (params, opt_state), metrics = jax.lax.scan(
                step, (params, opt_state), (domain, initial, boundary)
            )
            return (
                params,
                opt_state,
                jax.tree_util.tree_map(jnp.mean, metrics),
            )

        def evaluate_epoch(params, stacked):
            domain, initial, boundary = stacked

            def step(_, batch):
                domain_batch, initial_batch, boundary_batch = batch
                _, metrics = loss_fn(
                    params, domain_batch, initial_batch, boundary_batch
                )
                return None, metrics

            _, metrics = jax.lax.scan(
                step, None, (domain, initial, boundary)
            )
            return jax.tree_util.tree_map(jnp.mean, metrics)

        def train_epoch_block(
            params, opt_state, stacked_block, _epoch=train_epoch
        ):
            """A whole block of epochs (leading epoch axis on every
            ``stacked_block`` leaf) as one compiled program: one
            dispatch and one host sync per block instead of per epoch,
            which dominates wall time when epochs are short."""

            def epoch(carry, stacked):
                params, opt_state = carry
                params, opt_state, metrics = _epoch(
                    params, opt_state, stacked
                )
                return (params, opt_state), metrics

            (params, opt_state), metrics = jax.lax.scan(
                epoch, (params, opt_state), stacked_block
            )
            return params, opt_state, metrics

        if mesh is None:
            train_epoch = jax.jit(train_epoch)
            evaluate_epoch = jax.jit(evaluate_epoch)
            train_epoch_block = jax.jit(train_epoch_block)
        else:
            # parameters/optimizer state replicated, batches sharded
            # (carried by the device_put placement of `stacked`)
            train_epoch = jax.jit(
                train_epoch,
                in_shardings=(replicated, replicated, None),
                out_shardings=(replicated, replicated, replicated),
            )
            evaluate_epoch = jax.jit(
                evaluate_epoch,
                in_shardings=(replicated, None),
                out_shardings=replicated,
            )
            train_epoch_block = jax.jit(
                train_epoch_block,
                in_shardings=(replicated, replicated, None),
                out_shardings=(replicated, replicated, replicated),
            )

        history: Dict[str, list] = {}
        params = model.params

        # without per-epoch host observers (callbacks, prints), the
        # whole training run compiles into scans over per-epoch PRNG
        # keys: the dataset lives on device and each epoch's shuffled
        # Cartesian-product batches are gathered in-program, so a run
        # costs one dispatch per validation interval (or one total)
        # with zero per-epoch host work or host->device data motion
        if (
            mesh is None
            and not optimization_args.callbacks
            and not (
                optimization_args.verbose
                and optimization_args.verbose != "auto"
            )
        ):
            device_data, epoch_fn = (
                training_iterator.device_epoch_inputs()
            )
            # compiled programs are cached across train() calls on the
            # same model/optimizer/data-shape (jax.jit caches on
            # function identity, and these closures would otherwise be
            # rebuilt — and recompiled — every call): warmup runs and
            # repeated retraining pay compilation once
            signature = (
                jax.tree_util.tree_map(
                    lambda leaf: (leaf.shape, leaf.dtype), device_data
                ),
                training_iterator.domain_batch_size,
                training_iterator.initial_batch_size,
                training_iterator.boundary_batch_size,
            )
            cached = self._train_programs
            if (
                cached is not None
                and cached["model"] is model
                and cached["optimizer"] is optimizer
                and cached["signature"] == signature
            ):
                train_epochs = cached["train_epochs"]
                evaluate_epoch = cached["evaluate_epoch"]
            else:

                def train_epochs(
                    params, opt_state, keys, data, _epoch=train_epoch
                ):
                    def epoch(carry, key):
                        params, opt_state = carry
                        params, opt_state, metrics = _epoch(
                            params, opt_state, epoch_fn(data, key)
                        )
                        return (params, opt_state), metrics

                    (params, opt_state), metrics = jax.lax.scan(
                        epoch, (params, opt_state), keys
                    )
                    return params, opt_state, metrics

                train_epochs = jax.jit(train_epochs)
                self._train_programs = {
                    "model": model,
                    "optimizer": optimizer,
                    "signature": signature,
                    "train_epochs": train_epochs,
                    "evaluate_epoch": evaluate_epoch,
                }
            epochs = optimization_args.epochs
            keys = jax.random.split(
                jax.random.fold_in(
                    jax.random.PRNGKey(optimization_args.seed), 1
                ),
                max(epochs, 1),
            )
            chunk_len = (
                optimization_args.validation_frequency
                if validation_iterator is not None
                else max(epochs, 1)
            )
            validation_stacked = (
                jax.tree_util.tree_map(
                    jnp.asarray,
                    validation_iterator.stacked_batches(),
                )
                if validation_iterator is not None
                else None
            )
            metric_chunks = []
            validation_chunks = []
            epoch = 0
            while epoch < epochs:
                block = min(chunk_len, epochs - epoch)
                params, opt_state, metrics = train_epochs(
                    params,
                    opt_state,
                    keys[epoch: epoch + block],
                    device_data,
                )
                metric_chunks.append(metrics)
                epoch += block
                if (
                    validation_iterator is not None
                    and epoch % optimization_args.validation_frequency
                    == 0
                ):
                    validation_chunks.append(
                        evaluate_epoch(params, validation_stacked)
                    )
            # one host sync for the whole run: materialize the metric
            # history only after every chunk is dispatched
            for metrics in metric_chunks:
                for key, value in metrics.items():
                    history.setdefault(key, []).extend(
                        np.asarray(value)
                    )
            for metrics in validation_chunks:
                for key, value in metrics.items():
                    history.setdefault(f"val_{key}", []).append(
                        np.asarray(value)
                    )
            model.params = params
            self._model = model
            test_metrics = None
            if test_iterator is not None:
                test_metrics = {
                    key: np.asarray(value)
                    for key, value in evaluate_epoch(
                        params, test_iterator.stacked_batches()
                    ).items()
                }
            return history, test_metrics

        # sharded training (a device mesh): epochs are host-stacked in
        # blocks and the per-step batch axis is sharded over the mesh;
        # one dispatch and one metric sync per block instead of per
        # epoch
        if not optimization_args.callbacks and not (
            optimization_args.verbose
            and optimization_args.verbose != "auto"
        ):
            sample = training_iterator.stacked_batches()
            epoch_bytes = sum(
                leaf.nbytes
                for leaf in jax.tree_util.tree_leaves(sample)
            )
            max_block = max(
                1, min(256, (256 << 20) // max(epoch_bytes, 1))
            )
            epoch = 0
            epochs = optimization_args.epochs
            while epoch < epochs:
                block = min(max_block, epochs - epoch)
                if validation_iterator is not None:
                    frequency = optimization_args.validation_frequency
                    block = min(
                        block, frequency - epoch % frequency
                    )
                chunk = [sample] + [
                    training_iterator.stacked_batches()
                    for _ in range(block - 1)
                ]
                sample = None
                stacked_block = jax.tree_util.tree_map(
                    lambda *leaves: np.stack(leaves), *chunk
                )
                params, opt_state, metrics = train_epoch_block(
                    params,
                    opt_state,
                    shard_stacked(stacked_block, batch_axis=2),
                )
                for key, value in metrics.items():
                    history.setdefault(key, []).extend(
                        np.asarray(value)
                    )
                epoch += block
                if (
                    validation_iterator is not None
                    and epoch % optimization_args.validation_frequency
                    == 0
                ):
                    validation_metrics = evaluate_epoch(
                        params,
                        shard_stacked(
                            validation_iterator.stacked_batches()
                        ),
                    )
                    for key, value in validation_metrics.items():
                        history.setdefault(f"val_{key}", []).append(
                            np.asarray(value)
                        )
                if epoch < epochs:
                    sample = training_iterator.stacked_batches()
            model.params = params
            self._model = model
            test_metrics = None
            if test_iterator is not None:
                test_metrics = {
                    key: np.asarray(value)
                    for key, value in evaluate_epoch(
                        params,
                        shard_stacked(
                            test_iterator.stacked_batches()
                        ),
                    ).items()
                }
            return history, test_metrics

        for epoch in range(optimization_args.epochs):
            stacked = shard_stacked(training_iterator.stacked_batches())
            params, opt_state, metrics = train_epoch(
                params, opt_state, stacked
            )
            logs = {
                key: np.asarray(value)
                for key, value in metrics.items()
            }
            for key, value in logs.items():
                history.setdefault(key, []).append(value)

            if (
                validation_iterator is not None
                and (epoch + 1) % optimization_args.validation_frequency
                == 0
            ):
                validation_metrics = evaluate_epoch(
                    params, shard_stacked(validation_iterator.stacked_batches())
                )
                for key, value in validation_metrics.items():
                    history.setdefault(f"val_{key}", []).append(
                        np.asarray(value)
                    )

            if optimization_args.verbose and (
                optimization_args.verbose != "auto"
            ):
                print(
                    f"epoch {epoch + 1}/{optimization_args.epochs}: "
                    f"loss={float(logs['loss']):.6g}"
                )
            for callback in optimization_args.callbacks:
                callback(epoch, logs)

        model.params = params
        self._model = model

        test_metrics = None
        if test_iterator is not None:
            test_metrics = {
                key: np.asarray(value)
                for key, value in evaluate_epoch(
                    params, shard_stacked(test_iterator.stacked_batches())
                ).items()
            }

        return history, test_metrics

    # -- helpers -----------------------------------------------------------

    def _validate_auto_regressive_mode(
        self, cp: ConstrainedProblem, t_interval: TemporalDomainInterval
    ):
        if t_interval != (0.0, self._d_t):
            raise ValueError(
                "in auto-regressive mode, the training time interval "
                f"{t_interval} must range from 0 to the time step size "
                f"of the operator ({self._d_t})"
            )
        diff_eq = cp.differential_equation
        t_symbol = diff_eq.symbols.t
        if any(
            t_symbol in rhs.free_symbols
            for rhs in diff_eq.symbolic_equation_system.rhs
        ):
            raise ValueError(
                "auto-regressive mode is not compatible with "
                "differential equations whose right-hand sides contain "
                "any t terms"
            )
        if (
            diff_eq.x_dimension
            and not cp.are_all_boundary_conditions_static
        ):
            raise ValueError(
                "auto-regressive mode is not compatible with dynamic "
                "boundary conditions"
            )

    def _create_iterator(
        self,
        cp: ConstrainedProblem,
        t_interval: TemporalDomainInterval,
        data_args: Optional[DataArgs],
    ):
        if not data_args:
            return None
        dataset = Dataset(
            cp=cp,
            t_interval=t_interval,
            y_0_functions=data_args.y_0_functions,
            point_sampler=self._sampler,
            n_domain_points=data_args.n_domain_points,
            n_boundary_points=data_args.n_boundary_points,
            vertex_oriented=self._vertex_oriented,
        )
        return dataset.get_iterator(
            n_batches=data_args.n_batches,
            n_ic_repeats=data_args.n_ic_repeats,
            shuffle=data_args.shuffle,
        )
