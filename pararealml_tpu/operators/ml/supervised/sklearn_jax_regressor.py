"""A scikit-learn-protocol regressor around a Flax model.

Capability match for /root/reference/pararealml/operators/ml/supervised/
sklearn_keras_regressor.py:13-214 (``get_params``/``set_params``/``fit``/
``predict``/``score``, batched prediction with a cap, validation split,
callbacks) with the Keras engine replaced by a Flax module + optax
optimizer. Training runs as a jitted ``lax.scan`` over the shuffled
mini-batches of each epoch — one device dispatch per epoch when the
dataset is device-resident, with the data passed as arguments (never
baked into the program as constants). Datasets beyond a configurable
device-memory budget (``max_device_data_bytes``) are instead streamed
to the device in shuffled host shards per epoch, the counterpart of the
reference's lazy ``tf.data`` GPU loading (``lazy_load_to_gpu``).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Union

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
from sklearn.base import BaseEstimator, RegressorMixin


class SKLearnJaxRegressor(RegressorMixin, BaseEstimator):
    """A wrapper for Flax regression models implementing the
    scikit-learn estimator interface (``BaseEstimator`` provides the
    tag protocol newer scikit-learn meta-estimators such as
    ``GridSearchCV`` require; ``get_params``/``set_params`` are
    overridden below to expose ``build_fn`` keyword arguments as
    tunable hyperparameters, matching the reference's Keras wrapper)."""

    def __init__(
        self,
        build_fn: Callable[..., nn.Module],
        batch_size: int = 256,
        epochs: int = 1000,
        optimizer: Optional[optax.GradientTransformation] = None,
        verbose: Union[int, str] = "auto",
        callbacks: Sequence[Callable[[int, Dict[str, float]], None]] = (),
        validation_split: float = 0.0,
        validation_frequency: int = 1,
        max_predict_batch_size: Optional[int] = None,
        seed: int = 0,
        max_device_data_bytes: Optional[int] = None,
        device_mesh=None,
        **build_args: Any,
    ):
        """
        :param build_fn: a function returning the Flax module to wrap
        :param batch_size: the training batch size
        :param epochs: the number of training epochs
        :param optimizer: the optax optimizer (Adam(1e-3) by default)
        :param verbose: 0 silences epoch logging
        :param callbacks: callables invoked as ``callback(epoch, logs)``
            after each epoch
        :param validation_split: the share of the data held out for
            validation
        :param validation_frequency: epochs between validation passes
        :param max_predict_batch_size: cap on the prediction batch size
        :param seed: the PRNG seed for initialization and shuffling
        :param max_device_data_bytes: device-memory budget for the
            training set; datasets larger than this are streamed to the
            device in shuffled host shards per epoch instead of living
            resident in HBM (the counterpart of the reference's lazy
            ``tf.data`` GPU loading, /root/reference/pararealml/
            operators/ml/supervised/sklearn_keras_regressor.py:109-166);
            ``None`` (the default) keeps the whole dataset on device
        :param device_mesh: an optional ``jax.sharding.Mesh`` for
            data-parallel training: the training set and every batch
            are sharded over the mesh's first axis while the parameters
            and optimizer state stay replicated, with the gradient
            all-reduces inserted by XLA's SPMD partitioner — the
            training program is the same traced code as the
            single-device one. ``batch_size`` must be divisible by the
            mesh's device count. The reference trains on a single GPU
            (sklearn_keras_regressor.py); this is headroom for
            oracle datasets and surrogates too large for one device.
        :param build_args: parameters passed through to ``build_fn``
        """
        self.build_fn = build_fn
        self.batch_size = batch_size
        self.epochs = epochs
        self.optimizer = optimizer
        self.verbose = verbose
        self.callbacks = callbacks
        self.validation_split = validation_split
        self.validation_frequency = validation_frequency
        self.max_predict_batch_size = max_predict_batch_size
        self.seed = seed
        self.max_device_data_bytes = max_device_data_bytes
        self.device_mesh = device_mesh
        self.build_args = build_args

        self._module: Optional[nn.Module] = None
        self._params = None
        self._history: Dict[str, list] = {}

    # -- model access ------------------------------------------------------

    @property
    def module(self) -> Optional[nn.Module]:
        """The underlying Flax module."""
        return self._module

    @property
    def params(self):
        """The trained parameters."""
        return self._params

    @params.setter
    def params(self, params):
        self._params = params

    @property
    def model(self):
        """The (module, params) pair of the fitted model."""
        return self._module, self._params

    @model.setter
    def model(self, model):
        self._module, self._params = model

    @property
    def history(self) -> Dict[str, list]:
        """Per-epoch training (and validation) losses."""
        return self._history

    # -- sklearn protocol --------------------------------------------------

    def get_params(self, **_: Any) -> Dict[str, Any]:
        params = {
            "build_fn": self.build_fn,
            "batch_size": self.batch_size,
            "epochs": self.epochs,
            "optimizer": self.optimizer,
            "verbose": self.verbose,
            "callbacks": self.callbacks,
            "validation_split": self.validation_split,
            "validation_frequency": self.validation_frequency,
            "max_predict_batch_size": self.max_predict_batch_size,
            "seed": self.seed,
            "max_device_data_bytes": self.max_device_data_bytes,
            "device_mesh": self.device_mesh,
        }
        params.update(self.build_args)
        return params

    def set_params(self, **parameters: Any) -> "SKLearnJaxRegressor":
        build_fn_arg_names = list(
            inspect.signature(self.build_fn).parameters.keys()
        )
        for key, value in parameters.items():
            if hasattr(self, key) and key != "build_args":
                setattr(self, key, value)
            elif key in build_fn_arg_names:
                self.build_args[key] = value
            else:
                raise ValueError(f"invalid parameter '{key}'")
        return self

    def fit(self, x: np.ndarray, y: np.ndarray) -> "SKLearnJaxRegressor":
        data_bytes = x.nbytes + y.nbytes
        streaming = (
            self.max_device_data_bytes is not None
            and data_bytes > self.max_device_data_bytes
        )
        if not streaming:
            x = jnp.asarray(x)
            y = jnp.asarray(y)
        else:
            x = np.asarray(x)
            y = np.asarray(y)

        self._module = self.build_fn(**self.build_args)
        self._jit_apply = None
        key = jax.random.PRNGKey(self.seed)
        key, init_key = jax.random.split(key)
        self._params = self._module.init(
            init_key, jnp.asarray(x[:1])
        )

        optimizer = self.optimizer or optax.adam(1e-3)
        opt_state = optimizer.init(self._params)

        if self.validation_split:
            key, split_key = jax.random.split(key)
            permutation = np.asarray(
                jax.random.permutation(split_key, len(x))
            )
            n_validation = max(1, int(len(x) * self.validation_split))
            validation_idx = permutation[:n_validation]
            train_idx = permutation[n_validation:]
            x_train, y_train = x[train_idx], y[train_idx]
            x_validate = jnp.asarray(x[validation_idx])
            y_validate = jnp.asarray(y[validation_idx])
        else:
            x_train, y_train = x, y
            x_validate = y_validate = None

        module = self._module
        batch_size = min(self.batch_size, len(x_train))
        n_batches = len(x_train) // batch_size

        mesh = self.device_mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            data_axis = mesh.axis_names[0]
            n_data_shards = mesh.shape[data_axis]
            if batch_size % n_data_shards:
                raise ValueError(
                    f"batch size ({batch_size}) must be divisible by "
                    f"the device mesh's {n_data_shards} shards for "
                    "data-parallel training"
                )
            replicated = NamedSharding(mesh, PartitionSpec())
            # (n_batches, batch_size, ...features) with the per-step
            # batch axis sharded over the data axis; the parameters
            # stay replicated, so XLA inserts the gradient all-reduce
            batch_sharding = NamedSharding(
                mesh, PartitionSpec(None, data_axis)
            )

            def constrain_batches(xs, ys):
                return (
                    jax.lax.with_sharding_constraint(xs, batch_sharding),
                    jax.lax.with_sharding_constraint(ys, batch_sharding),
                )

        else:

            def constrain_batches(xs, ys):
                return xs, ys

        def loss_fn(params, xb, yb):
            prediction = module.apply(params, xb)
            return jnp.mean(jnp.square(prediction - yb))

        # the dataset rides in as *arguments*, never as jit closure
        # constants: closed-over concrete arrays are baked into the
        # compiled program, which both bloats it (a multi-hundred-MB
        # oracle dataset becomes a multi-hundred-MB executable) and
        # re-compiles on every fit
        def run_batches(params, opt_state, xs, ys):
            xs, ys = constrain_batches(xs, ys)

            def step(carry, batch):
                params, opt_state = carry
                xb, yb = batch
                loss, grads = jax.value_and_grad(loss_fn)(params, xb, yb)
                updates, opt_state = optimizer.update(
                    grads, opt_state, params
                )
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), (xs, ys)
            )
            return params, opt_state, jnp.sum(losses)

        if mesh is None:
            run_batches_jit = jax.jit(run_batches)
        else:
            run_batches_jit = jax.jit(
                run_batches,
                in_shardings=(
                    replicated,
                    replicated,
                    batch_sharding,
                    batch_sharding,
                ),
                out_shardings=(replicated, replicated, replicated),
            )

        def train_epoch_resident(
            params, opt_state, shuffle_key, x_dev, y_dev
        ):
            permutation = jax.random.permutation(shuffle_key, len(x_dev))[
                : n_batches * batch_size
            ]
            xs = x_dev[permutation].reshape(
                (n_batches, batch_size) + x_dev.shape[1:]
            )
            ys = y_dev[permutation].reshape(
                (n_batches, batch_size) + y_dev.shape[1:]
            )
            params, opt_state, loss_sum = run_batches(
                params, opt_state, xs, ys
            )
            return params, opt_state, loss_sum / n_batches

        if mesh is None:
            train_epoch_resident = jax.jit(train_epoch_resident)
        else:
            train_epoch_resident = jax.jit(
                train_epoch_resident,
                in_shardings=(replicated, replicated, None, None, None),
                out_shardings=(replicated, replicated, replicated),
            )

        if streaming:
            # host-streaming fit: the dataset exceeds the device budget
            # (the reference's lazy tf.data GPU loading,
            # /root/reference/pararealml/operators/ml/supervised/
            # sklearn_keras_regressor.py:109-166) — stream shuffled
            # host shards per epoch, every shard one device dispatch of
            # a fixed batch count so the scan compiles exactly once
            row_bytes = max(
                1, x_train[:1].nbytes + y_train[:1].nbytes
            )
            shard_batches = max(
                1,
                min(
                    n_batches,
                    int(self.max_device_data_bytes)
                    // max(1, row_bytes * batch_size),
                ),
            )
            shard_rows = shard_batches * batch_size
            rng = np.random.default_rng(self.seed)

            def train_epoch_streaming(params, opt_state):
                permutation = rng.permutation(len(x_train))
                loss_total = jnp.zeros(())
                for start in range(0, n_batches, shard_batches):
                    idx = permutation[
                        start
                        * batch_size: (start + shard_batches)
                        * batch_size
                    ]
                    if len(idx) < shard_rows:
                        # pad the final shard by wrapping around the
                        # epoch's permutation so shapes stay static
                        idx = np.concatenate(
                            [idx, permutation[: shard_rows - len(idx)]]
                        )
                    xs = jnp.asarray(
                        x_train[idx].reshape(
                            (shard_batches, batch_size)
                            + x_train.shape[1:]
                        )
                    )
                    ys = jnp.asarray(
                        y_train[idx].reshape(
                            (shard_batches, batch_size)
                            + y_train.shape[1:]
                        )
                    )
                    params, opt_state, loss_sum = run_batches_jit(
                        params, opt_state, xs, ys
                    )
                    loss_total = loss_total + loss_sum
                n_run = -(-n_batches // shard_batches) * shard_batches
                return params, opt_state, loss_total / n_run

        validation_loss_fn = jax.jit(loss_fn)

        self._history = {"loss": []}
        if x_validate is not None:
            self._history["val_loss"] = []

        params = self._params
        for epoch in range(self.epochs):
            key, shuffle_key = jax.random.split(key)
            if streaming:
                params, opt_state, loss = train_epoch_streaming(
                    params, opt_state
                )
            else:
                params, opt_state, loss = train_epoch_resident(
                    params, opt_state, shuffle_key, x_train, y_train
                )
            logs = {"loss": float(loss)}
            self._history["loss"].append(float(loss))
            if (
                x_validate is not None
                and (epoch + 1) % self.validation_frequency == 0
            ):
                val_loss = float(
                    validation_loss_fn(params, x_validate, y_validate)
                )
                logs["val_loss"] = val_loss
                self._history["val_loss"].append(val_loss)
            if self.verbose and self.verbose != "auto":
                print(f"epoch {epoch + 1}/{self.epochs}: {logs}")
            for callback in self.callbacks:
                callback(epoch, logs)

        self._params = params
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self._module is None:
            raise ValueError("model has not been fitted")
        apply = self._apply_fn()

        cap = self.max_predict_batch_size
        if self.device_mesh is not None:
            # one placement for the whole call, not one per chunk; a
            # no-op after a data-parallel fit, and covers models
            # fitted (or loaded) without the mesh
            from jax.sharding import NamedSharding, PartitionSpec

            self._params = jax.device_put(
                self._params,
                NamedSharding(self.device_mesh, PartitionSpec()),
            )
        if cap is None or len(x) <= cap:
            return np.asarray(
                apply(self._params, self._place_predict_batch(x))
            )

        outputs = []
        for start in range(0, len(x), cap):
            batch = self._place_predict_batch(x[start: start + cap])
            outputs.append(np.asarray(apply(self._params, batch)))
        return np.concatenate(outputs, axis=0)

    def _place_predict_batch(self, batch):
        """Shards an inference batch over the device mesh (each device
        scores its slice with the replicated parameters); batches that
        do not divide the device count stay on one device."""
        batch = jnp.asarray(batch)
        if (
            self.device_mesh is None
            or len(batch) % self._n_data_shards() != 0
        ):
            return batch
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(
            batch,
            NamedSharding(
                self.device_mesh,
                PartitionSpec(self.device_mesh.axis_names[0]),
            ),
        )

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        prediction = self.predict(x)
        return -float(np.mean(np.square(prediction - y)))

    def save(self, path: str) -> None:
        """Saves the fitted parameters to ``path``."""
        if self._params is None:
            raise ValueError("model has not been fitted")
        from pararealml_tpu.utils.checkpoint import save_pytree

        save_pytree(path, self._params)

    def load(self, path: str, x_sample: np.ndarray) -> None:
        """Restores parameters saved with :meth:`save`; ``x_sample`` is a
        sample input batch used to rebuild the module structure."""
        from pararealml_tpu.utils.checkpoint import load_pytree

        self._module = self.build_fn(**self.build_args)
        self._jit_apply = None
        template = self._module.init(
            jax.random.PRNGKey(self.seed), jnp.asarray(x_sample[:1])
        )
        self._params = load_pytree(path, template)

    def _n_data_shards(self) -> int:
        data_axis = self.device_mesh.axis_names[0]
        return self.device_mesh.shape[data_axis]

    def _apply_fn(self):
        if not hasattr(self, "_jit_apply") or self._jit_apply is None:
            module = self._module
            self._jit_apply = jax.jit(
                lambda params, inputs: module.apply(params, inputs)
            )
        return self._jit_apply
