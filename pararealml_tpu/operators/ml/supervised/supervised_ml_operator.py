"""Supervised operator learning.

Capability match for /root/reference/pararealml/operators/ml/supervised/
supervised_ml_operator.py:16-578: an operator that learns solution jumps
of size ``d_t`` from an oracle solver, with auto-regressive /
time-variant / input-d_t modes, perturbation-based data generation
(including ``isolate_perturbations`` and ``repeat_on_error``), model
fitting with train/test splitting, and auto-regressive roll-out
inference.

JAX-native redesign of the parallelism: the reference fans data
generation out over ``multiprocessing`` workers (P2 in SURVEY.md §2);
here, when the oracle is a :class:`JaxOperator` on static-BC problems,
the perturbed solves of *all* iterations are batched through ``jax.vmap``
and executed as a single device program per time step — the ``n_jobs``
argument is accepted for API compatibility but device batching replaces
process parallelism. When the fitted model is an
:class:`SKLearnJaxRegressor`, the operator also exposes a pure
``trajectory_function`` (the roll-out as a ``lax.scan`` of the jitted
network), making trained surrogates usable as coarse operators inside
the fully compiled shard_map Parareal — the north-star composition.

Note: the reference's ODE input placeholder omits the d_t column in
``input_d_t`` mode (supervised_ml_operator.py:359-370 allocates
``y_dimension + time_variant`` columns only); this implementation
includes it.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from sklearn.metrics import mean_squared_error
from sklearn.model_selection import train_test_split

from pararealml_tpu.constrained_problem import ConstrainedProblem
from pararealml_tpu.initial_condition import DiscreteInitialCondition
from pararealml_tpu.initial_value_problem import InitialValueProblem
from pararealml_tpu.operator import (
    JaxOperator,
    Operator,
    discretize_time_domain,
)
from pararealml_tpu.operators.ml.supervised.sklearn_jax_regressor import (
    SKLearnJaxRegressor,
)
from pararealml_tpu.solution import Solution


class SupervisedMLOperator(JaxOperator):
    """An operator that learns to map the state at ``t`` to the state at
    ``t + d_t`` from data generated by a high-fidelity oracle."""

    def __init__(
        self,
        d_t: float,
        vertex_oriented: bool,
        auto_regressive: bool = True,
        time_variant: bool = False,
        input_d_t: bool = False,
    ):
        if not auto_regressive and not time_variant:
            raise ValueError(
                "operator must be time variant if auto-regression is "
                "disabled"
            )
        if time_variant and input_d_t:
            raise ValueError(
                "operator must be time invariant to use d_t as an input"
            )
        super().__init__(d_t, vertex_oriented)
        self._auto_regressive = auto_regressive
        self._time_variant = time_variant
        self._input_d_t = input_d_t
        self._model: Optional[Any] = None

    @property
    def auto_regressive(self) -> bool:
        """Whether inference feeds predictions back as inputs."""
        return self._auto_regressive

    @property
    def time_variant(self) -> bool:
        """Whether the time value is a model input."""
        return self._time_variant

    @property
    def input_d_t(self) -> bool:
        """Whether the operator step size is a model input."""
        return self._input_d_t

    @property
    def model(self) -> Optional[Any]:
        """The regression model behind the operator."""
        return self._model

    @model.setter
    def model(self, model: Optional[Any]):
        self._model = model

    # -- inference ---------------------------------------------------------

    def solve(
        self, ivp: InitialValueProblem, parallel_enabled: bool = True
    ) -> Solution:
        if self._model is None:
            raise ValueError("operator has no model")

        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        y_shape = cp.y_shape(self._vertex_oriented)
        t = discretize_time_domain(ivp.t_interval, self._d_t)[1:]

        inputs = self._create_input_placeholder(cp)
        n_y_features = (
            inputs.shape[1]
            - diff_eq.x_dimension
            - (self._time_variant or self._input_d_t)
        )

        y = np.empty((len(t),) + tuple(y_shape))
        y_i = ivp.initial_condition.discrete_y_0(self._vertex_oriented)
        for i, t_i in enumerate(t):
            inputs[:, :n_y_features] = y_i.reshape((1, -1))
            if self._time_variant:
                inputs[:, n_y_features] = t_i
            elif self._input_d_t:
                inputs[:, n_y_features] = self._d_t

            prediction = self._model.predict(inputs)
            y[i] = prediction.reshape(y_shape)
            if self._auto_regressive:
                y_i = prediction

        return Solution(
            ivp,
            t,
            y,
            vertex_oriented=self._vertex_oriented,
            d_t=self._d_t,
        )

    def _build_apply_model(self, cp):
        """Resolves the jittable per-step model application
        ``apply_model(y_flat, t_value) -> prediction`` (the model's own
        ``jax_step_map`` when it exposes one — the fitted-operator
        matmuls of the state-operator regressors — otherwise the
        trunk-hoisted DeepONet fast path when the model shape allows
        it, tiled generic input layout otherwise) plus the discrete
        solution shape. Requires an :class:`SKLearnJaxRegressor` model
        or one exposing the ``jax_step_map`` protocol (e.g.
        :class:`StateOperatorRidgeRegressor`,
        :class:`ReducedQuadraticStateOperatorRegressor`)."""
        step_map = getattr(self._model, "jax_step_map", None)
        if step_map is not None:
            # the fitted operator is the step map itself: dense
            # matmuls (affine fits additionally pass
            # Parareal's linear-propagator probe, collapsing the
            # coarse sweeps to log-depth doubling scans)
            y_shape = tuple(cp.y_shape(self._vertex_oriented))

            def apply_model(y_flat, t_value):
                return step_map(y_flat)

            return apply_model, y_shape
        if not isinstance(self._model, SKLearnJaxRegressor):
            raise ValueError(
                "a jittable trajectory function requires an "
                "SKLearnJaxRegressor model or one exposing "
                "jax_step_map (e.g. StateOperatorRidgeRegressor)"
            )
        module, params = self._model.model
        diff_eq = cp.differential_equation
        y_shape = tuple(cp.y_shape(self._vertex_oriented))

        if diff_eq.x_dimension:
            x = jnp.asarray(
                cp.mesh.all_index_coordinates(
                    self._vertex_oriented, flatten=True
                )
            )
            n_points = len(x)
        else:
            x = None
            n_points = 1

        time_feature = self._time_variant or self._input_d_t

        apply_model = self._build_hoisted_deeponet_apply(
            module,
            params,
            x,
            time_feature,
            int(np.prod(y_shape)),
        )
        if apply_model is None:

            def build_inputs(y_flat, t_value):
                columns = [
                    jnp.tile(y_flat[jnp.newaxis], (n_points, 1))
                ]
                if time_feature:
                    columns.append(
                        jnp.full((n_points, 1), t_value, y_flat.dtype)
                    )
                if x is not None:
                    columns.append(x.astype(y_flat.dtype))
                return jnp.concatenate(columns, axis=-1)

            def apply_model(y_flat, t_value):
                return module.apply(
                    params, build_inputs(y_flat, t_value)
                )

        return apply_model, y_shape

    def trajectory_function(
        self, cp, t_interval, time_parallel=False
    ):
        """A pure jittable roll-out of the trained network over the time
        grid (requires an :class:`SKLearnJaxRegressor` model)."""
        apply_model, y_shape = self._build_apply_model(cp)
        t = discretize_time_domain(t_interval, self._d_t)
        t_offsets = jnp.asarray(t[1:] - t[0])
        auto_regressive = self._auto_regressive
        d_t = self._d_t

        if time_parallel and auto_regressive and not self._time_variant:
            # a time-invariant auto-regressive surrogate whose network
            # is affine in the state (e.g. a linear-branch/linear-
            # combiner DeepONet — the architecture that makes the
            # Parareal iteration contract) IS an affine step map, so
            # the parallel-in-time machinery built for linear FDM
            # problems applies verbatim: probe (P, r) once at build
            # time, expose the composed slice map, and Parareal's
            # coarse sweeps collapse to log-depth doubling scans of
            # matmuls instead of n dependent network roll-outs.
            # Nonlinear surrogates fail the probe's affinity
            # verification and keep the scan roll-out below.
            from pararealml_tpu.ops.linear_propagator import (
                _MAX_DIM,
                build_linear_propagator_trajectory,
            )

            dim = int(np.prod(y_shape))
            if dim <= _MAX_DIM:

                def affine_probe_step(y, i, t_value):
                    prediction = apply_model(
                        jnp.ravel(y),
                        jnp.asarray(d_t, jnp.result_type(y)),
                    )
                    return prediction.reshape(y_shape)

                try:
                    trajectory = build_linear_propagator_trajectory(
                        cp, affine_probe_step, len(t) - 1, y_shape
                    )
                    return trajectory, t[1:]
                except ValueError:
                    pass  # not affine in the state: scan roll-out

        def trajectory(y_0, t_0):
            y_0_flat = jnp.ravel(y_0)

            def step(carry, t_offset):
                t_value = (
                    t_0 + t_offset if self._time_variant else d_t
                )
                prediction = apply_model(carry, t_value)
                prediction_flat = jnp.ravel(prediction)
                next_carry = (
                    prediction_flat if auto_regressive else carry
                )
                return next_carry, prediction.reshape(y_shape)

            _, ys = jax.lax.scan(step, y_0_flat, t_offsets)
            return ys

        return trajectory, t[1:]

    def ends_function(self, cp, t_interval):
        """The carry-only counterpart of :meth:`trajectory_function`:
        a jittable ``fn(y_0, t_0) -> y_end`` that never stacks per-step
        predictions. Parareal's correction iterations consume only
        slice END states (the reference likewise discards slice
        interiors, /root/reference/pararealml/operators/parareal/
        parareal_operator.py:163-185), so a nonlinear surrogate
        composed as a Parareal sub-operator rolls out without writing
        a ``(steps, *grid)`` trajectory per sub-solve. (Affine
        surrogates take the propagator path in
        :meth:`trajectory_function`, whose ``end_function`` Parareal
        prefers outright.)"""
        apply_model, y_shape = self._build_apply_model(cp)
        t = discretize_time_domain(t_interval, self._d_t)
        t_offsets = jnp.asarray(t[1:] - t[0])
        auto_regressive = self._auto_regressive
        time_variant = self._time_variant
        d_t = self._d_t

        def ends(y_0, t_0):
            if not auto_regressive:
                # no prediction feedback: the end state is just the
                # final step's prediction — one model application
                return apply_model(
                    jnp.ravel(y_0),
                    t_0 + t_offsets[-1] if time_variant else d_t,
                ).reshape(y_shape)

            def step(carry, t_offset):
                t_value = t_0 + t_offset if time_variant else d_t
                return jnp.ravel(apply_model(carry, t_value)), None

            last_carry, _ = jax.lax.scan(
                step, jnp.ravel(y_0), t_offsets
            )
            return last_carry.reshape(y_shape)

        return ends

    @staticmethod
    def _build_hoisted_deeponet_apply(
        module, params, x, time_feature, n_y_features
    ):
        """For a (possibly :class:`Standardized`-wrapped)
        :class:`DeepONet` whose branch consumes exactly the flattened
        state (``n_y_features`` values), returns
        ``apply(y_flat, t_value) -> (n_points, y_dim)`` with the trunk
        evaluated ONCE over the (constant) mesh coordinates instead of
        on every step, and the branch evaluated on the state vector
        once instead of on ``n_points`` copies of it. This is the hot
        path of a Parareal coarse sweep — a serial scan of surrogate
        inferences — where the generic layout pays ``n_points``
        redundant branch matmuls and a full trunk net per step for
        bit-identical output. Returns None when the model is not of
        this shape (the generic tiled layout is used instead); every
        value is computed in the state's dtype, matching the generic
        layout's ``x.astype(y_flat.dtype)`` cast."""
        from pararealml_tpu.operators.ml.deeponet import (
            DeepONet,
            Standardized,
        )

        if x is None or time_feature:
            return None
        inner = module
        wrapper = None
        if isinstance(module, Standardized):
            wrapper = module
            inner = module.inner
        if not isinstance(inner, DeepONet):
            return None
        if inner.branch_net_input_size != n_y_features:
            # the branch does not consume exactly the flattened state
            # (e.g. a custom split); the generic layout handles it
            return None
        if wrapper is not None and len(wrapper.x_mean) != (
            n_y_features + x.shape[1]
        ):
            return None

        don_params = params["params"]
        if wrapper is not None:
            don_params = don_params["inner"]
        branch_params = {"params": don_params["branch_net"]}
        trunk_params = {"params": don_params["trunk_net"]}
        combiner_params = {"params": don_params["combiner_net"]}

        # the trunk input is constant across the whole time scan:
        # evaluate the trunk net once, eagerly, here (in the mesh
        # coordinates' dtype — at worst one widening vs the generic
        # layout's per-step cast of x to the state dtype)
        coords = x
        if wrapper is not None:
            coord_stats_lo = jnp.asarray(
                wrapper.x_mean[n_y_features:], x.dtype
            )
            coord_stats_scale = jnp.asarray(
                wrapper.x_std[n_y_features:], x.dtype
            )
            coords = (coords - coord_stats_lo) / coord_stats_scale
        trunk_output = inner.trunk_net.apply(trunk_params, coords)

        def apply(y_flat, _t_value):
            dtype = y_flat.dtype
            branch_input = y_flat[jnp.newaxis]
            if wrapper is not None:
                branch_input = (
                    branch_input
                    - jnp.asarray(
                        wrapper.x_mean[:n_y_features], dtype
                    )
                ) / jnp.asarray(wrapper.x_std[:n_y_features], dtype)
            branch_output = inner.branch_net.apply(
                branch_params, branch_input
            ).astype(dtype)
            trunk = trunk_output.astype(dtype)
            branch_tiled = jnp.broadcast_to(branch_output, trunk.shape)
            combiner_input = jnp.concatenate(
                [branch_tiled, trunk, branch_tiled * trunk],
                axis=-1,
            )
            prediction = inner.combiner_net.apply(
                combiner_params, combiner_input
            )
            if wrapper is not None:
                prediction = jnp.asarray(
                    wrapper.y_mean, dtype
                ) + jnp.asarray(wrapper.y_std, dtype) * prediction
            # pin the output to the state dtype so the auto-regressive
            # scan carry keeps a stable dtype even when the mesh
            # coordinates are wider (e.g. f32 states under x64)
            return prediction.astype(dtype)

        return apply

    # -- data generation ---------------------------------------------------

    def generate_data(
        self,
        ivp: InitialValueProblem,
        oracle: Operator,
        iterations: int,
        perturbation_function: Callable[[float, np.ndarray], np.ndarray],
        isolate_perturbations: bool = False,
        repeat_on_error: bool = False,
        n_jobs: int = 1,
        seeds: Optional[Sequence[int]] = None,
        device_mesh=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Generates (inputs, targets) pairs by solving perturbed sub-IVPs
        with the oracle.

        ``n_jobs``/``seeds`` exist for API compatibility with the
        reference's multiprocessing fan-out
        (/root/reference/pararealml/operators/ml/supervised/
        supervised_ml_operator.py); batching over iterations on device
        replaces process parallelism (``seeds[0]`` seeds NumPy if
        provided). ``device_mesh`` scales the fan-out *across chips*:
        the perturbation batch shards over the mesh's first axis and
        every device solves its share of the oracle sub-IVPs (requires
        ``iterations`` divisible by the device count; the batch runs on
        one device otherwise).
        """
        if iterations <= 0:
            raise ValueError("number of iterations must be greater than 0")
        if n_jobs < 1:
            raise ValueError("number of jobs must be greater than 0")
        if seeds is not None:
            if len(seeds) != n_jobs:
                raise ValueError(
                    f"number of seeds ({len(seeds)}) must match number "
                    f"of jobs ({n_jobs})"
                )
            np.random.seed(seeds[0])

        if self._can_batch_on_device(ivp, oracle, repeat_on_error):
            return self._generate_data_batched(
                ivp,
                oracle,
                iterations,
                perturbation_function,
                isolate_perturbations,
                device_mesh=device_mesh,
            )
        return self._generate_data_sequential(
            ivp,
            oracle,
            iterations,
            perturbation_function,
            isolate_perturbations,
            repeat_on_error,
        )

    def fit_model(
        self,
        model: Any,
        data: Tuple[np.ndarray, np.ndarray],
        test_size: float = 0.2,
        score_func: Callable[
            [np.ndarray, np.ndarray], float
        ] = mean_squared_error,
    ) -> Tuple[float, Optional[float]]:
        """Fits the model to a random training split of the data, stores
        it, and returns the training and test scores.

        Models tagged ``requires_state_blocks`` (e.g.
        :class:`StateOperatorRidgeRegressor`) consume whole per-state
        row blocks, so the split is drawn over state samples instead of
        individual rows, keeping every block contiguous."""
        if getattr(model, "requires_state_blocks", False):
            y_rows = np.asarray(data[1]).reshape(len(data[0]), -1)
            block = model.state_size // y_rows.shape[1]
            n_samples = len(data[0]) // block
            samples = np.random.permutation(n_samples)
            n_test = round(n_samples * test_size)
            test_samples = samples[:n_test]
            train_samples = samples[n_test:]

            def gather(sample_indices):
                rows = (
                    sample_indices[:, np.newaxis] * block
                    + np.arange(block)
                ).ravel()
                return data[0][rows], data[1][rows]

            x_train, y_train = gather(train_samples)
            x_test, y_test = (
                gather(test_samples) if n_test else (None, None)
            )
        elif test_size:
            x_train, x_test, y_train, y_test = train_test_split(
                data[0], data[1], test_size=test_size
            )
        else:
            shuffled = np.random.permutation(len(data[0]))
            x_train, y_train = data[0][shuffled], data[1][shuffled]
            x_test = y_test = None

        model.fit(x_train, y_train)
        self._model = model

        train_score = score_func(y_train, model.predict(x_train))
        test_score = (
            score_func(y_test, model.predict(x_test))
            if test_size
            else None
        )
        return train_score, test_score

    def train(
        self,
        ivp: InitialValueProblem,
        oracle: Operator,
        model: Any,
        iterations: int,
        perturbation_function: Callable[[float, np.ndarray], np.ndarray],
        isolate_perturbations: bool = False,
        repeat_on_error: bool = False,
        n_jobs: int = 1,
        seeds: Optional[Sequence[int]] = None,
        test_size: float = 0.2,
        score_func: Callable[
            [np.ndarray, np.ndarray], float
        ] = mean_squared_error,
        device_mesh=None,
    ) -> Tuple[float, Optional[float]]:
        """Generates oracle data and fits the model to it."""
        data = self.generate_data(
            ivp,
            oracle,
            iterations,
            perturbation_function,
            isolate_perturbations=isolate_perturbations,
            repeat_on_error=repeat_on_error,
            n_jobs=n_jobs,
            seeds=seeds,
            device_mesh=device_mesh,
        )
        return self.fit_model(
            model, data, test_size=test_size, score_func=score_func
        )

    # -- internals ---------------------------------------------------------

    def _create_input_placeholder(
        self, cp: ConstrainedProblem
    ) -> np.ndarray:
        """Creates the model input array layout: flattened state features,
        an optional t (or d_t) column, and for PDEs the coordinates of
        each mesh point (one row per point)."""
        import jax

        diff_eq = cp.differential_equation
        time_feature = int(self._time_variant or self._input_d_t)
        # match the device compute precision: float64 data buys nothing
        # when x64 is off, and halves host memory and transfer volume
        dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        if not diff_eq.x_dimension:
            return np.empty(
                (1, diff_eq.y_dimension + time_feature), dtype
            )

        x = cp.mesh.all_index_coordinates(
            self._vertex_oriented, flatten=True
        )
        y_features = np.empty(
            (len(x), diff_eq.y_dimension * len(x)), dtype
        )
        columns = [y_features]
        if time_feature:
            columns.append(np.empty((len(x), 1), dtype))
        columns.append(x.astype(dtype))
        return np.hstack(columns)

    def _apply_static_constraints(self, cp, y: np.ndarray) -> np.ndarray:
        if (
            self._vertex_oriented
            and cp.static_y_vertex_constraints is not None
        ):
            return np.asarray(cp.static_y_vertex_constraints.apply(y))
        return y

    def _can_batch_on_device(
        self, ivp: InitialValueProblem, oracle: Operator, repeat: bool
    ) -> bool:
        cp = ivp.constrained_problem
        return (
            isinstance(oracle, JaxOperator)
            and not repeat
            and (
                not cp.differential_equation.x_dimension
                or (
                    cp.are_all_boundary_conditions_static
                    and oracle.vertex_oriented == self._vertex_oriented
                )
            )
        )

    def _record_rows(
        self,
        inputs: np.ndarray,
        targets: np.ndarray,
        row_offset: int,
        n_points: int,
        y_start: np.ndarray,
        y_end: np.ndarray,
        t_value: Optional[float],
        x_dim: int,
        y_dim: int,
    ):
        block = slice(row_offset, row_offset + n_points)
        n_y_features = (
            inputs.shape[1]
            - x_dim
            - (self._time_variant or self._input_d_t)
        )
        inputs[block, :n_y_features] = y_start.reshape((1, -1))
        if t_value is not None:
            inputs[block, n_y_features] = t_value
        targets[block] = y_end.reshape((-1, y_dim))

    def _generate_data_sequential(
        self,
        ivp: InitialValueProblem,
        oracle: Operator,
        iterations: int,
        perturbation_function,
        isolate_perturbations: bool,
        repeat_on_error: bool,
    ) -> Tuple[np.ndarray, np.ndarray]:
        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        x_dim, y_dim = diff_eq.x_dimension, diff_eq.y_dimension

        t = discretize_time_domain(ivp.t_interval, self._d_t)
        y_0 = ivp.initial_condition.discrete_y_0(self._vertex_oriented)

        unperturbed_states = None
        if self._auto_regressive and isolate_perturbations and len(t) > 2:
            unperturbed = self._perturb_and_solve(
                InitialValueProblem(
                    cp, (t[0], t[-2]), ivp.initial_condition
                ),
                lambda _, y: y,
                oracle,
                False,
            ).discrete_y(self._vertex_oriented)
            step_indices = (
                np.rint((t[1:-1] - t[0]) / oracle.d_t).astype(int) - 1
            )
            unperturbed_states = unperturbed[step_indices]

        placeholder = self._create_input_placeholder(cp)
        n_points = placeholder.shape[0]
        n_steps = len(t) - 1
        inputs = np.tile(placeholder, (iterations * n_steps, 1))
        targets = np.empty((len(inputs), y_dim), inputs.dtype)

        for iteration in range(iterations):
            offset = iteration * n_points * n_steps
            if self._auto_regressive:
                y_i = y_0
                for i, t_i in enumerate(t[:-1]):
                    solution = self._perturb_and_solve(
                        InitialValueProblem(
                            cp,
                            (t_i, t_i + self._d_t),
                            DiscreteInitialCondition(
                                cp, y_i, self._vertex_oriented
                            ),
                        ),
                        perturbation_function,
                        oracle,
                        repeat_on_error,
                    )
                    sub_ivp = solution.initial_value_problem
                    perturbed_start = (
                        sub_ivp.initial_condition.discrete_y_0(
                            self._vertex_oriented
                        )
                    )
                    perturbed_end = solution.discrete_y(
                        self._vertex_oriented
                    )[-1]
                    self._record_rows(
                        inputs,
                        targets,
                        offset + i * n_points,
                        n_points,
                        perturbed_start,
                        perturbed_end,
                        t[i + 1]
                        if self._time_variant
                        else (self._d_t if self._input_d_t else None),
                        x_dim,
                        y_dim,
                    )
                    y_i = (
                        unperturbed_states[i]
                        if isolate_perturbations and i < n_steps - 1
                        else perturbed_end
                    )
            else:
                solution = self._perturb_and_solve(
                    ivp, perturbation_function, oracle, repeat_on_error
                )
                perturbed_ivp = solution.initial_value_problem
                perturbed_y_0 = (
                    perturbed_ivp.initial_condition.discrete_y_0(
                        self._vertex_oriented
                    )
                )
                trajectory = solution.discrete_y(self._vertex_oriented)
                step_indices = (
                    np.rint((t[1:] - t[0]) / oracle.d_t).astype(int) - 1
                )
                states = trajectory[step_indices]
                for i in range(n_steps):
                    self._record_rows(
                        inputs,
                        targets,
                        offset + i * n_points,
                        n_points,
                        perturbed_y_0,
                        states[i],
                        t[i + 1] if self._time_variant else None,
                        x_dim,
                        y_dim,
                    )

        return inputs, targets

    def _generate_data_batched(
        self,
        ivp: InitialValueProblem,
        oracle: JaxOperator,
        iterations: int,
        perturbation_function,
        isolate_perturbations: bool,
        device_mesh=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batches the oracle solves of all iterations through ``vmap``:
        host-side perturbation, one device program per time step
        (auto-regressive) or one overall (otherwise). With
        ``device_mesh``, the vmapped batch axis shards over the mesh so
        every device solves its share of the perturbed sub-IVPs."""
        batch_jit_kwargs = {}
        if device_mesh is not None:
            data_axis = device_mesh.axis_names[0]
            if iterations % device_mesh.shape[data_axis] == 0:
                from jax.sharding import NamedSharding, PartitionSpec

                batch_sharding = NamedSharding(
                    device_mesh, PartitionSpec(data_axis)
                )
                batch_jit_kwargs = {
                    "in_shardings": (batch_sharding, None),
                    "out_shardings": batch_sharding,
                }
        cp = ivp.constrained_problem
        diff_eq = cp.differential_equation
        x_dim, y_dim = diff_eq.x_dimension, diff_eq.y_dimension

        t = discretize_time_domain(ivp.t_interval, self._d_t)
        n_steps = len(t) - 1
        y_0 = ivp.initial_condition.discrete_y_0(self._vertex_oriented)

        placeholder = self._create_input_placeholder(cp)
        n_points = placeholder.shape[0]
        inputs = np.tile(placeholder, (iterations * n_steps, 1))
        targets = np.empty((len(inputs), y_dim), inputs.dtype)

        def perturb_batch(t_value, states):
            perturbed = []
            for state in states:
                perturbed_state = perturbation_function(t_value, state)
                if perturbed_state.shape != state.shape:
                    raise ValueError(
                        f"perturbed y shape {perturbed_state.shape} "
                        f"must match input y shape {state.shape}"
                    )
                perturbed.append(
                    self._apply_static_constraints(cp, perturbed_state)
                )
            return np.stack(perturbed)

        if self._auto_regressive:
            # the step function is vmapped over perturbation batches
            step_fn, _ = oracle.trajectory_function(
                cp, (t[0], t[0] + self._d_t)
            )
            batched_end = jax.jit(
                jax.vmap(
                    lambda y, t_start: step_fn(y, t_start)[-1],
                    in_axes=(0, None),
                ),
                **batch_jit_kwargs,
            )
            unperturbed_states = None
            if isolate_perturbations:
                single_end = jax.jit(
                    lambda y, t_start: step_fn(y, t_start)[-1]
                )
                unperturbed_states = [np.asarray(y_0)]
                for i in range(n_steps - 1):
                    unperturbed_states.append(
                        np.asarray(
                            single_end(unperturbed_states[-1], t[i])
                        )
                    )

            states = np.tile(
                y_0[np.newaxis], (iterations,) + (1,) * y_0.ndim
            )
            for i in range(n_steps):
                perturbed = perturb_batch(t[i], states)
                ends = np.asarray(batched_end(jnp.asarray(perturbed),
                                              t[i]))
                for iteration in range(iterations):
                    self._record_rows(
                        inputs,
                        targets,
                        (iteration * n_steps + i) * n_points,
                        n_points,
                        perturbed[iteration],
                        ends[iteration],
                        t[i + 1]
                        if self._time_variant
                        else (self._d_t if self._input_d_t else None),
                        x_dim,
                        y_dim,
                    )
                if isolate_perturbations and i < n_steps - 1:
                    states = np.tile(
                        unperturbed_states[i + 1][np.newaxis],
                        (iterations,) + (1,) * y_0.ndim,
                    )
                else:
                    states = ends
        else:
            trajectory_fn, _ = oracle.trajectory_function(
                cp, (t[0], t[-1])
            )
            batched_trajectory = jax.jit(
                jax.vmap(trajectory_fn, in_axes=(0, None)),
                **batch_jit_kwargs,
            )
            perturbed = perturb_batch(t[0], [y_0] * iterations)
            trajectories = np.asarray(
                batched_trajectory(jnp.asarray(perturbed), t[0])
            )
            step_indices = (
                np.rint((t[1:] - t[0]) / oracle.d_t).astype(int) - 1
            )
            for iteration in range(iterations):
                states = trajectories[iteration][step_indices]
                for i in range(n_steps):
                    self._record_rows(
                        inputs,
                        targets,
                        (iteration * n_steps + i) * n_points,
                        n_points,
                        perturbed[iteration],
                        states[i],
                        t[i + 1] if self._time_variant else None,
                        x_dim,
                        y_dim,
                    )

        return inputs, targets

    def _perturb_and_solve(
        self,
        ivp: InitialValueProblem,
        perturbation_function,
        oracle: Operator,
        repeat_on_error: bool,
    ) -> Solution:
        while True:
            y_0 = ivp.initial_condition.discrete_y_0(
                self._vertex_oriented
            )
            perturbed_y_0 = perturbation_function(
                ivp.t_interval[0], y_0
            )
            if perturbed_y_0.shape != y_0.shape:
                raise ValueError(
                    f"perturbed y shape {perturbed_y_0.shape} must "
                    f"match input y shape {y_0.shape}"
                )
            perturbed_ivp = InitialValueProblem(
                ivp.constrained_problem,
                ivp.t_interval,
                DiscreteInitialCondition(
                    ivp.constrained_problem,
                    perturbed_y_0,
                    self._vertex_oriented,
                ),
            )
            try:
                return oracle.solve(perturbed_ivp)
            except Exception as exception:
                if repeat_on_error:
                    warnings.warn(
                        "Failed to solve IVP with perturbed initial "
                        f"conditions; {str(exception)}"
                    )
                    continue
                raise
