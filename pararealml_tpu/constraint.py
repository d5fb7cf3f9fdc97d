"""Traceable value constraints.

Array-native rethink of the reference's ``Constraint`` (see
/root/reference/pararealml/constraint.py:6-131). The reference stores a
compressed 1D value vector plus a boolean mask and mutates arrays in place
via fancy indexing; neither pattern traces under ``jax.jit``. Here a
constraint is an immutable pytree of two dense, same-shaped arrays — a
boolean ``mask`` and a ``values`` array whose entries are meaningful only
where the mask is ``True`` — and application is a pure ``jnp.where``, which
XLA fuses into neighbouring element-wise work for free.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

Array = Union[np.ndarray, jax.Array]


@jax.tree_util.register_pytree_node_class
class Constraint:
    """A dense, traceable representation of constraints on an array.

    Unlike the reference implementation, both ``mask`` and ``values`` span
    the full constrained region; unconstrained positions simply carry a
    ``False`` mask bit (their value entries are ignored). This makes every
    operation a fused element-wise select instead of a scatter.
    """

    def __init__(self, values: Array, mask: Array):
        values = jnp.asarray(values)
        mask = jnp.asarray(mask, dtype=bool)
        if values.shape != mask.shape:
            raise ValueError(
                f"values shape {values.shape} must match mask shape "
                f"{mask.shape}"
            )
        self._values = values
        self._mask = mask

    @property
    def values(self) -> jax.Array:
        """The dense constraint value array."""
        return self._values

    @property
    def mask(self) -> jax.Array:
        """The boolean array flagging which positions are constrained."""
        return self._mask

    @property
    def shape(self):
        return self._mask.shape

    def apply(self, array: Array) -> jax.Array:
        """Returns a copy of ``array`` with constrained positions replaced
        by the constraint values (pure; broadcasts over leading axes).
        """
        array = jnp.asarray(array)
        self._check_broadcastable(array.shape)
        return jnp.where(self._mask, self._values, array)

    def multiply_and_add(
        self, addend: Array, multiplier: Union[float, Array], result: Array
    ) -> jax.Array:
        """Returns ``result`` with constrained positions set to
        ``addend + multiplier * values`` (pure).

        Mirrors the halo-synthesis primitive of the reference
        (constraint.py:60-101) used to build Neumann ghost cells.
        """
        addend = jnp.asarray(addend)
        result = jnp.asarray(result)
        self._check_broadcastable(result.shape)
        return jnp.where(
            self._mask, addend + multiplier * self._values, result
        )

    def _check_broadcastable(self, shape):
        mask_shape = self._mask.shape
        if len(shape) < len(mask_shape) or (
            tuple(shape[len(shape) - len(mask_shape):]) != tuple(mask_shape)
            and mask_shape != ()
        ):
            raise ValueError(
                f"array shape {shape} incompatible with constraint shape "
                f"{mask_shape}"
            )

    @classmethod
    def from_nan_masked(cls, array: Array) -> "Constraint":
        """Builds a constraint from an array in which NaN marks
        *unconstrained* positions (the reference's NaN convention,
        constrained_problem.py:433-476).
        """
        array = np.asarray(array, dtype=float)
        mask = ~np.isnan(array)
        return cls(np.where(mask, array, 0.0), mask)

    # -- pytree protocol --------------------------------------------------

    def tree_flatten(self):
        return (self._values, self._mask), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj._values, obj._mask = children
        return obj

    def __repr__(self):
        return f"Constraint(shape={self._mask.shape})"


def apply_constraints_along_last_axis(
    constraint: Optional[Constraint], array: Array
) -> jax.Array:
    """Applies an optional constraint spanning the full last axis.

    In this framework a single :class:`Constraint` covers all components of
    y at once (the reference instead loops over a sequence of per-component
    constraints, constraint.py:104-131); ``None`` is an explicit no-op so
    ODE paths can share code with PDE paths.
    """
    array = jnp.asarray(array)
    if constraint is None:
        return array
    return constraint.apply(array)
