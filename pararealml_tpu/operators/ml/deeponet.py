"""Deep Operator Network in Flax.

Capability match for /root/reference/pararealml/operators/ml/
deeponet.py:8-95: a DeepONet variant whose combiner network consumes the
branch output, the trunk output, and their element-wise product (see
https://arxiv.org/abs/1910.03193 for the vanilla architecture). The
reference builds on Keras; here the model is a Flax ``linen`` module —
a pure function of its parameters — so it can be jitted, vmapped,
differentiated for physics-informed training, and rolled out inside
``lax.scan`` for auto-regressive inference on the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp


class FNN(nn.Module):
    """A plain fully connected network (the building block the reference
    examples assemble with ``tf.keras.Sequential``).

    :param layer_sizes: the sizes of the hidden and output layers
    :param activation: the hidden-layer activation
    """

    layer_sizes: Sequence[int]
    activation: Callable[[jax.Array], jax.Array] = nn.tanh

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        for size in self.layer_sizes[:-1]:
            x = self.activation(nn.Dense(size)(x))
        return nn.Dense(self.layer_sizes[-1])(x)


class Standardized(nn.Module):
    """Wraps a regression module with input/output standardization baked
    into the forward graph: the inner module sees z-scored features and
    produces z-scored targets, de-standardized on the way out.

    Because the scaling lives inside the module, every compiled consumer
    of the ``(module, params)`` pair — batched prediction, the
    supervised auto-regressive roll-out, the Parareal coarse sweep —
    gets one self-contained function; no separate scaler object to
    thread through jit boundaries. The statistics are fixed constants
    computed from the training set (:meth:`from_data`), mirroring a
    Keras ``Normalization`` layer adapted before training.

    :param inner: the wrapped regression module
    :param x_mean: per-feature input means
    :param x_std: per-feature input standard deviations
    :param y_mean: per-dimension output means
    :param y_std: per-dimension output standard deviations
    """

    inner: nn.Module
    x_mean: Sequence[float]
    x_std: Sequence[float]
    y_mean: Sequence[float]
    y_std: Sequence[float]

    def __call__(self, x: jax.Array) -> jax.Array:
        x_mean = jnp.asarray(self.x_mean, x.dtype)
        x_std = jnp.asarray(self.x_std, x.dtype)
        y_mean = jnp.asarray(self.y_mean, x.dtype)
        y_std = jnp.asarray(self.y_std, x.dtype)
        return y_mean + y_std * self.inner((x - x_mean) / x_std)

    @staticmethod
    def from_data(
        inner: nn.Module,
        x,
        y,
        epsilon: float = 1e-7,
    ) -> "Standardized":
        """Builds the wrapper with statistics of the given training set
        (``epsilon`` floors the standard deviations so constant features
        pass through unscaled rather than dividing by zero)."""
        import numpy as np

        x = np.asarray(x)
        y = np.asarray(y)
        x_std = np.std(x, axis=0)
        y_std = np.std(y, axis=0)
        return Standardized(
            inner,
            tuple(np.mean(x, axis=0).tolist()),
            tuple(np.where(x_std < epsilon, 1.0, x_std).tolist()),
            tuple(np.mean(y, axis=0).tolist()),
            tuple(np.where(y_std < epsilon, 1.0, y_std).tolist()),
        )


class DeepONet(nn.Module):
    """A Deep Operator Network with a combiner head.

    The input is the concatenation of the branch input (initial condition
    sensor readings) and the trunk input (domain coordinates); the
    combiner net maps ``[branch, trunk, branch * trunk]`` to the output.

    :param branch_net: processes the first ``branch_net_input_size``
        input features
    :param trunk_net: processes the remaining (coordinate) features
    :param combiner_net: combines the branch and trunk outputs
    :param branch_net_input_size: the size of the branch net's input
    """

    branch_net: nn.Module
    trunk_net: nn.Module
    combiner_net: nn.Module
    branch_net_input_size: int

    def __call__(self, inputs: jax.Array) -> jax.Array:
        branch_input = inputs[..., : self.branch_net_input_size]
        trunk_input = inputs[..., self.branch_net_input_size:]
        branch_output = self.branch_net(branch_input)
        trunk_output = self.trunk_net(trunk_input)
        combiner_input = jnp.concatenate(
            [
                branch_output,
                trunk_output,
                branch_output * trunk_output,
            ],
            axis=-1,
        )
        return self.combiner_net(combiner_input)
