"""On-device rectilinear-grid interpolation.

On-device replacement for the host-side SciPy ``interpn`` calls the
reference makes when resampling solutions and initial conditions
between mesh orientations (/root/reference/pararealml/solution.py:114-180,
/root/reference/pararealml/initial_condition.py:95-121): a jittable
multilinear interpolator over the mesh's rectilinear axes. Query points
outside the grid hull are evaluated by linearly extending the edge
cell's interpolant — the vertex<->cell-center resampling reads a
half-cell band beyond the cell-center hull at every face, so plain
clamping would bias the boundary vertices.

The interpolator is vectorized over arbitrary trailing value axes (a
whole ``(time, y_dimension)`` trajectory resamples in one gather) and
runs under ``jit`` on any backend.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

_SUPPORTED_METHODS = ("linear", "nearest")


def _cell_index_and_offset(
    axis: jax.Array, queries: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """For each query coordinate, the index of the grid cell whose
    interpolant evaluates it and the query's fractional offset within
    that cell.

    Out-of-hull queries map to the nearest edge cell with an offset
    outside [0, 1], which makes the multilinear blend extrapolate."""
    point_count = axis.shape[0]
    if point_count < 2:
        # a degenerate single-point axis contributes nothing to the
        # blend; pin every query to that point
        zeros = jnp.zeros(queries.shape, queries.dtype)
        return jnp.zeros(queries.shape, jnp.int32), zeros
    cell = jnp.clip(
        jnp.searchsorted(axis, queries, side="right") - 1,
        0,
        point_count - 2,
    )
    lower = axis[cell]
    return cell, (queries - lower) / (axis[cell + 1] - lower)


def grid_interpolate(
    values: jax.Array,
    axis_points: Sequence[jax.Array],
    x: jax.Array,
    method: str = "linear",
) -> jax.Array:
    """Interpolates grid-sampled values at arbitrary query points.

    :param values: array whose leading ``len(axis_points)`` axes span
        the grid; any trailing axes are carried through the blend.
    :param axis_points: one strictly increasing 1D coordinate array per
        grid axis.
    :param x: query points of shape ``(..., len(axis_points))``.
    :param method: ``"linear"`` (multilinear, linearly extrapolating
        outside the hull) or ``"nearest"``.
    :return: array of shape ``x.shape[:-1] + values.shape[d:]``.
    """
    if method not in _SUPPORTED_METHODS:
        raise ValueError(
            f"unsupported interpolation method '{method}'; supported "
            f"methods are {_SUPPORTED_METHODS}"
        )
    values = jnp.asarray(values)
    x = jnp.asarray(x)
    dimensions = len(axis_points)
    if x.shape[-1] != dimensions:
        raise ValueError(
            f"query point dimensionality ({x.shape[-1]}) must match the "
            f"number of grid axes ({dimensions})"
        )
    queries = x.reshape(-1, dimensions)
    trailing_shape = values.shape[dimensions:]
    table = values.reshape(values.shape[:dimensions] + (-1,))

    cells = []
    offsets = []
    for axis_index in range(dimensions):
        axis = jnp.asarray(axis_points[axis_index], table.dtype)
        cell, offset = _cell_index_and_offset(
            axis, queries[:, axis_index].astype(table.dtype)
        )
        if method == "nearest":
            cell = cell + (offset > 0.5).astype(cell.dtype)
            offset = jnp.zeros_like(offset)
        cells.append(cell)
        offsets.append(offset)

    if method == "nearest":
        return table[tuple(cells)].reshape(
            x.shape[:-1] + trailing_shape
        )

    # multilinear blend: accumulate the 2^d cell corners, each weighted
    # by the product of per-axis offsets (or their complements)
    accumulated = jnp.zeros(
        (queries.shape[0], table.shape[-1]), table.dtype
    )
    for corner in range(2**dimensions):
        corner_index = []
        weight = jnp.ones((queries.shape[0],), table.dtype)
        for axis_index in range(dimensions):
            takes_upper = (corner >> axis_index) & 1
            corner_index.append(cells[axis_index] + takes_upper)
            weight = weight * (
                offsets[axis_index]
                if takes_upper
                else 1.0 - offsets[axis_index]
            )
        accumulated = accumulated + (
            table[tuple(corner_index)] * weight[:, jnp.newaxis]
        )
    return accumulated.reshape(x.shape[:-1] + trailing_shape)
