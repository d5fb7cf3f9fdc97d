"""Finite-difference spatial differentiation as fused XLA stencils.

Capability match for /root/reference/pararealml/operators/fdm/
numerical_differentiator.py:14-1242: three-point central differences with
constraint-aware boundary handling, the full vector-calculus suite
(gradient, Hessian, divergence, curl, scalar/vector Laplacian) in
Cartesian, polar, cylindrical and spherical coordinates, and a Jacobi
anti-Laplacian solver.

Array-native design: every operation is a pure function of dense arrays —
halos come from ``jnp.pad``-style concatenation, Neumann ghost vertices
are synthesized with masked selects from dense
:class:`~pararealml_tpu.constraint.Constraint` tensors, and the Jacobi
iteration is a ``lax.while_loop``. XLA fuses the shifted slices, metric
terms, and constraint selects of a whole right-hand side into a handful
of kernels, which is why no hand-written Pallas stencil is needed for
the memory-bound path (the arithmetic intensity of a 5-point stencil is
fixed; fusion is the only lever, and XLA already takes it).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from pararealml_tpu.constrained_problem import BoundaryConstraintPair
from pararealml_tpu.constraint import Constraint
from pararealml_tpu.mesh import CoordinateSystem, Mesh

# Per-axis sequence of optional lower/upper constraint pairs on the
# derivative of y normal to the boundaries of that axis.
DerivativeBoundaryConstraints = Sequence[Optional[BoundaryConstraintPair]]


def _face(y: jax.Array, axis: int, side: int, width: int = 1) -> jax.Array:
    """The ``width``-thick boundary slab of ``y`` along ``axis``
    (side 0 = lower, 1 = upper)."""
    index = [slice(None)] * y.ndim
    index[axis] = slice(0, width) if side == 0 else slice(-width, None)
    return y[tuple(index)]


def _inner_adjacent(y: jax.Array, axis: int, side: int) -> jax.Array:
    """The slab one vertex inward from the boundary along ``axis``."""
    index = [slice(None)] * y.ndim
    index[axis] = slice(1, 2) if side == 0 else slice(-2, -1)
    return y[tuple(index)]


def _set_face(
    y: jax.Array, axis: int, side: int, new_face: jax.Array
) -> jax.Array:
    """Returns ``y`` with its boundary slab along ``axis`` replaced."""
    index = [slice(None)] * y.ndim
    index[axis] = slice(0, 1) if side == 0 else slice(-1, None)
    return y.at[tuple(index)].set(new_face)


def _shifted(y_ext: jax.Array, axis: int, offset: int, length: int):
    """A length-``length`` window of the halo-extended array starting at
    ``offset`` along ``axis``."""
    return jax.lax.slice_in_dim(y_ext, offset, offset + length, axis=axis)


def slice_constraint(
    constraint: Optional[Constraint], component_slice
) -> Optional[Constraint]:
    """Slices a constraint's trailing (y component) axis."""
    if constraint is None:
        return None
    return Constraint(
        constraint.values[..., component_slice],
        constraint.mask[..., component_slice],
    )


def slice_constraint_pair(
    pair: Optional[BoundaryConstraintPair], component_slice
) -> Optional[BoundaryConstraintPair]:
    """Slices both sides of a boundary constraint pair along the y
    component axis."""
    if pair is None:
        return None
    return BoundaryConstraintPair(
        slice_constraint(pair.lower, component_slice),
        slice_constraint(pair.upper, component_slice),
    )


def slice_all_constraint_pairs(
    pairs: Optional[DerivativeBoundaryConstraints], component_slice
) -> Optional[Tuple[Optional[BoundaryConstraintPair], ...]]:
    """Slices every per-axis pair along the y component axis."""
    if pairs is None:
        return None
    return tuple(
        slice_constraint_pair(p, component_slice) for p in pairs
    )


class NumericalDifferentiator:
    """Base class holding the coordinate-system-aware vector calculus,
    expressed through the two stencil primitives ``_derivative`` and
    ``_second_derivative`` that subclasses implement."""

    def __init__(
        self,
        tol: float = 1e-3,
        max_iterations: int = 100_000,
        anti_laplacian_method: str = "jacobi",
    ):
        """
        :param tol: anti-Laplacian stopping tolerance — the 2-norm of
            the Jacobi update (equivalently, of the Jacobi-scaled
            residual) below which the solve is converged; both methods
            use the same criterion
        :param max_iterations: hard iteration cap for the solver loop
        :param anti_laplacian_method: ``"jacobi"`` (the reference's
            scheme, numerical_differentiator.py:872-927) or
            ``"bicgstab"`` — a Krylov solve of the same fixed-point
            equation via :func:`jax.scipy.sparse.linalg.bicgstab`,
            typically converging in O(sqrt) of Jacobi's iteration count
            on large or cold-started grids
        """
        if tol < 0.0:
            raise ValueError("tolerance must be non-negative")
        if anti_laplacian_method not in ("jacobi", "bicgstab"):
            raise ValueError(
                "anti-Laplacian method must be 'jacobi' or 'bicgstab' "
                f"but got {anti_laplacian_method!r}"
            )
        self._tol = tol
        self._max_iterations = max_iterations
        self._anti_laplacian_method = anti_laplacian_method

    @property
    def anti_laplacian_method(self) -> str:
        """The configured anti-Laplacian solver scheme."""
        return self._anti_laplacian_method

    # -- primitives implemented by subclasses ------------------------------

    def _derivative(
        self,
        y: jax.Array,
        d_x: float,
        x_axis: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        """The first derivative of y along ``x_axis`` at every vertex,
        with optional constraint overrides at the two boundaries."""
        raise NotImplementedError

    def _second_derivative(
        self,
        y: jax.Array,
        d_x1: float,
        d_x2: float,
        x_axis1: int,
        x_axis2: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        """The second derivative of y along the two axes, using the
        first-axis derivative boundary constraints to synthesize halos."""
        raise NotImplementedError

    def _next_anti_laplacian_estimate(
        self,
        y_hat: jax.Array,
        laplacian: jax.Array,
        mesh: Mesh,
        constraints: Optional[DerivativeBoundaryConstraints],
    ) -> jax.Array:
        """One Jacobi sweep toward the anti-Laplacian."""
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _normalize_constraints(
        constraints: Optional[DerivativeBoundaryConstraints],
        x_dimension: int,
    ) -> Tuple[Optional[BoundaryConstraintPair], ...]:
        if constraints is None:
            return (None,) * x_dimension
        if len(constraints) != x_dimension:
            raise ValueError(
                "expected derivative boundary constraints for "
                f"{x_dimension} axes but got {len(constraints)}"
            )
        return tuple(constraints)

    @staticmethod
    def _check_shape(y: jax.Array, mesh: Mesh, name: str = "y"):
        if tuple(y.shape[:-1]) != mesh.vertices_shape:
            raise ValueError(
                f"{name} shape up to second to last axis {y.shape[:-1]} "
                f"must match mesh vertices shape {mesh.vertices_shape}"
            )

    @staticmethod
    def _check_vector_field(y: jax.Array, mesh: Mesh):
        NumericalDifferentiator._check_shape(y, mesh)
        if y.shape[-1] != mesh.dimensions:
            raise ValueError(
                f"y value vector length ({y.shape[-1]}) must match number "
                f"of x dimensions ({mesh.dimensions})"
            )

    @staticmethod
    def _grid(mesh: Mesh, axis: int) -> jax.Array:
        return mesh.device_coordinate_grids(True)[axis][..., jnp.newaxis]

    # -- public vector calculus --------------------------------------------

    def gradient(
        self,
        y: jax.Array,
        mesh: Mesh,
        x_axis: int,
        derivative_boundary_constraints=None,
    ) -> jax.Array:
        """One column of the Jacobian of y, with the coordinate system's
        metric scaling applied."""
        self._check_shape(y, mesh)
        if not 0 <= x_axis < mesh.dimensions:
            raise ValueError(
                f"x-axis ({x_axis}) must be non-negative and less than "
                f"number of x dimensions ({mesh.dimensions})"
            )
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        derivative = self._derivative(
            y, mesh.d_x[x_axis], x_axis, bcs[x_axis]
        )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN or x_axis == 0:
            return derivative
        if cs == CoordinateSystem.SPHERICAL:
            r = self._grid(mesh, 0)
            if x_axis == 1:
                return derivative / (r * jnp.sin(self._grid(mesh, 2)))
            return derivative / r
        # polar / cylindrical
        if x_axis == 1:
            return derivative / self._grid(mesh, 0)
        return derivative

    def hessian(
        self,
        y: jax.Array,
        mesh: Mesh,
        x_axis1: int,
        x_axis2: int,
        derivative_boundary_constraints=None,
    ) -> jax.Array:
        """One component of the Hessian of y including all curvilinear
        metric terms."""
        self._check_shape(y, mesh)
        if not (
            0 <= x_axis1 < mesh.dimensions
            and 0 <= x_axis2 < mesh.dimensions
        ):
            raise ValueError(
                f"both first x-axis ({x_axis1}) and second x-axis "
                f"({x_axis2}) must be non-negative and less than number "
                f"of x dimensions ({mesh.dimensions})"
            )
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        d2 = self._second_derivative(
            y,
            mesh.d_x[x_axis1],
            mesh.d_x[x_axis2],
            x_axis1,
            x_axis2,
            bcs[x_axis1],
        )
        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return d2

        d1 = lambda axis: self._derivative(  # noqa: E731
            y, mesh.d_x[axis], axis, bcs[axis]
        )
        r = self._grid(mesh, 0)
        axes = (x_axis1, x_axis2)

        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2)
            sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
            if axes == (0, 0):
                return d2
            if axes == (1, 1):
                return (
                    d1(0)
                    + (d2 / sin_phi + cos_phi * d1(2)) / (r * sin_phi)
                ) / r
            if axes == (2, 2):
                return (d2 / r + d1(0)) / r
            if 0 in axes and 1 in axes:
                return (d2 - d1(1) / r) / (r * sin_phi)
            if 0 in axes and 2 in axes:
                return (d2 - d1(2) / r) / r
            # mixed theta-phi
            return (sin_phi * d2 - cos_phi * d1(1)) / (r * sin_phi) ** 2

        # polar / cylindrical
        if 1 not in axes:
            return d2
        if axes == (1, 1):
            return (d2 / r + d1(0)) / r
        if 0 in axes:
            return (d2 - d1(1) / r) / r
        # mixed theta-z (cylindrical)
        return d2 / r

    def divergence(
        self,
        y: jax.Array,
        mesh: Mesh,
        derivative_boundary_constraints=None,
    ) -> jax.Array:
        """The divergence of the vector field y."""
        self._check_vector_field(y, mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def comp_derivative(comp: int, axis: int) -> jax.Array:
            return self._derivative(
                y[..., comp: comp + 1],
                mesh.d_x[axis],
                axis,
                slice_constraint_pair(
                    bcs[axis], slice(comp, comp + 1)
                ),
            )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return sum(
                comp_derivative(i, i) for i in range(mesh.dimensions)
            )

        r = self._grid(mesh, 0)
        y_r = y[..., :1]
        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2)
            sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
            y_phi = y[..., 2:]
            return (
                comp_derivative(0, 0)
                + (
                    comp_derivative(2, 2)
                    + 2.0 * y_r
                    + (comp_derivative(1, 1) + cos_phi * y_phi) / sin_phi
                )
                / r
            )

        div = comp_derivative(0, 0) + (y_r + comp_derivative(1, 1)) / r
        if cs == CoordinateSystem.POLAR:
            return div
        return div + comp_derivative(2, 2)

    def curl(
        self,
        y: jax.Array,
        mesh: Mesh,
        curl_ind: int = 0,
        derivative_boundary_constraints=None,
    ) -> jax.Array:
        """The ``curl_ind``-th component of the curl of the vector field
        y (scalar in 2D)."""
        self._check_vector_field(y, mesh)
        if not 2 <= mesh.dimensions <= 3:
            raise ValueError(
                f"number of x dimensions ({mesh.dimensions}) must be 2 "
                "or 3"
            )
        if mesh.dimensions == 2 and curl_ind != 0:
            raise ValueError(
                f"curl index ({curl_ind}) must be 0 for 2D curl"
            )
        if not 0 <= curl_ind < mesh.dimensions:
            raise ValueError(
                f"curl index ({curl_ind}) must be non-negative and less "
                f"than number of x dimensions ({mesh.dimensions})"
            )
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def d(comp: int, axis: int) -> jax.Array:
            return self._derivative(
                y[..., comp: comp + 1],
                mesh.d_x[axis],
                axis,
                slice_constraint_pair(
                    bcs[axis], slice(comp, comp + 1)
                ),
            )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            if mesh.dimensions == 2 or curl_ind == 2:
                return d(1, 0) - d(0, 1)
            if curl_ind == 0:
                return d(2, 1) - d(1, 2)
            return d(0, 2) - d(2, 0)

        r = self._grid(mesh, 0)
        if cs == CoordinateSystem.SPHERICAL:
            y_theta = y[..., 1:2]
            y_phi = y[..., 2:]
            phi = self._grid(mesh, 2)
            sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
            if curl_ind == 0:
                return (
                    d(1, 2) + (cos_phi * y_theta - d(2, 1)) / sin_phi
                ) / r
            if curl_ind == 1:
                return d(2, 0) + (y_phi - d(0, 2)) / r
            return -d(1, 0) + (d(0, 1) / sin_phi - y_theta) / r

        # polar / cylindrical
        y_theta = y[..., 1:2]
        if cs == CoordinateSystem.POLAR or curl_ind == 2:
            return d(1, 0) + (y_theta - d(0, 1)) / r
        if curl_ind == 0:
            return d(2, 1) / r - d(1, 2)
        return d(0, 2) - d(2, 0)

    def laplacian(
        self,
        y: jax.Array,
        mesh: Mesh,
        derivative_boundary_constraints=None,
    ) -> jax.Array:
        """The element-wise scalar Laplacian of y."""
        self._check_shape(y, mesh)
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        def d1(axis):
            return self._derivative(y, mesh.d_x[axis], axis, bcs[axis])

        def d2(axis):
            return self._second_derivative(
                y, mesh.d_x[axis], mesh.d_x[axis], axis, axis, bcs[axis]
            )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return sum(d2(axis) for axis in range(mesh.dimensions))

        r = self._grid(mesh, 0)
        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2)
            sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
            return (
                d2(0)
                + (
                    2.0 * d1(0)
                    + (
                        d2(2)
                        + (cos_phi * d1(2) + d2(1) / sin_phi) / sin_phi
                    )
                    / r
                )
                / r
            )

        laplacian = d2(0) + (d2(1) / r + d1(0)) / r
        if cs == CoordinateSystem.POLAR:
            return laplacian
        return laplacian + d2(2)

    def vector_laplacian(
        self,
        y: jax.Array,
        mesh: Mesh,
        vector_laplacian_ind: int,
        derivative_boundary_constraints=None,
    ) -> jax.Array:
        """One component of the vector Laplacian of the vector field y.

        Note: in spherical coordinates the reference assigns the three
        component formulas cyclically mis-rotated across the indices
        (numerical_differentiator.py:773-841 puts the r-component
        expression under index 1); this implementation uses the standard
        assignment (r, azimuthal theta, polar phi at indices 0, 1, 2).
        """
        self._check_vector_field(y, mesh)
        if not 0 <= vector_laplacian_ind < mesh.dimensions:
            raise ValueError(
                f"vector Laplacian index ({vector_laplacian_ind}) must "
                "be non-negative and less than number of x dimensions "
                f"({mesh.dimensions})"
            )
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )
        ind = vector_laplacian_ind
        component_slice = slice(ind, ind + 1)
        laplacian = self.laplacian(
            y[..., component_slice],
            mesh,
            slice_all_constraint_pairs(bcs, component_slice),
        )

        cs = mesh.coordinate_system_type
        if cs == CoordinateSystem.CARTESIAN:
            return laplacian

        def d(comp: int, axis: int) -> jax.Array:
            return self._derivative(
                y[..., comp: comp + 1],
                mesh.d_x[axis],
                axis,
                slice_constraint_pair(
                    bcs[axis], slice(comp, comp + 1)
                ),
            )

        r = self._grid(mesh, 0)
        r_sqr = r**2
        y_r = y[..., :1]
        y_theta = y[..., 1:2]

        if cs == CoordinateSystem.SPHERICAL:
            phi = self._grid(mesh, 2)
            sin_phi, cos_phi = jnp.sin(phi), jnp.cos(phi)
            y_phi = y[..., 2:]
            if ind == 0:
                return laplacian - 2.0 * (
                    y_r
                    + d(2, 2)
                    + (cos_phi * y_phi + d(1, 1)) / sin_phi
                ) / r_sqr
            if ind == 1:
                return laplacian + 2.0 * (
                    d(0, 1) + (cos_phi * d(2, 1) - y_theta / 2.0) / sin_phi
                ) / (sin_phi * r_sqr)
            return laplacian + 2.0 * (
                d(0, 2)
                - (y_phi / 2.0 + cos_phi * d(1, 1)) / sin_phi**2
            ) / r_sqr

        # polar / cylindrical
        if ind == 0:
            return laplacian - (y_r + 2.0 * d(1, 1)) / r_sqr
        if ind == 1:
            return laplacian - (y_theta - 2.0 * d(0, 1)) / r_sqr
        return laplacian

    def anti_laplacian(
        self,
        laplacian: jax.Array,
        mesh: Mesh,
        y_constraints: Optional[Constraint],
        derivative_boundary_constraints=None,
        y_init: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Inverts the scalar Laplacian with Jacobi iteration inside a
        ``lax.while_loop``.

        Unlike the reference (which starts from a random array,
        numerical_differentiator.py:908-909), the default initial guess
        is zeros and callers (the FDM operator) warm-start with the
        previous time step's solution — deterministic and faster to
        converge.
        """
        self._check_shape(laplacian, mesh, "Laplacian")
        bcs = self._normalize_constraints(
            derivative_boundary_constraints, mesh.dimensions
        )

        if y_init is None:
            y = jnp.zeros_like(laplacian)
        else:
            if y_init.shape != laplacian.shape:
                raise ValueError(
                    f"y_init shape {y_init.shape} must match Laplacian "
                    f"shape {laplacian.shape}"
                )
            y = y_init
        if y_constraints is not None:
            y = y_constraints.apply(y)

        if self._anti_laplacian_method == "bicgstab":
            return self._anti_laplacian_bicgstab(
                y, laplacian, mesh, bcs, y_constraints
            )

        def cond(carry):
            _, diff, i = carry
            return (diff > self._tol) & (i < self._max_iterations)

        def body(carry):
            y_old, _, i = carry
            y_new = self._next_anti_laplacian_estimate(
                y_old, laplacian, mesh, bcs
            )
            if y_constraints is not None:
                y_new = y_constraints.apply(y_new)
            diff = jnp.linalg.norm(y_new - y_old)
            return y_new, diff, i + 1

        y_final, _, _ = jax.lax.while_loop(
            cond, body, (y, jnp.asarray(jnp.inf, laplacian.dtype), 0)
        )
        return y_final

    def _anti_laplacian_bicgstab(
        self,
        y_0: jax.Array,
        laplacian: jax.Array,
        mesh: Mesh,
        bcs: Tuple[Optional[BoundaryConstraintPair], ...],
        y_constraints: Optional[Constraint],
    ) -> jax.Array:
        """Solves the Jacobi fixed-point equation with BiCGStab.

        The converged Jacobi state satisfies ``y = C(S(y))`` where ``S``
        is one sweep and ``C`` re-applies the y constraints. Because the
        sweep is affine in ``y`` (``S(v) = B v + S(0)``: halo synthesis
        adds constants, the stencil is linear), that fixed point is the
        linear system ``v - notmask * B v = notmask * S(0) + mask *
        values``, i.e. the Jacobi-scaled (diagonally preconditioned)
        discrete Poisson system with Dirichlet rows pinned — which a
        Krylov method solves in far fewer matrix applications than the
        Jacobi relaxation itself. The convergence criterion matches
        Jacobi's exactly: the BiCGStab residual at a mask-respecting
        iterate IS ``C(S(y)) - y``, the Jacobi update, and the solve
        stops when its 2-norm reaches ``tol`` (``atol`` semantics; no
        relative component).
        """
        from jax.scipy.sparse.linalg import bicgstab

        def sweep(v):
            return self._next_anti_laplacian_estimate(
                v, laplacian, mesh, bcs
            )

        offset = sweep(jnp.zeros_like(laplacian))
        if y_constraints is None:

            def matvec(v):
                return v - (sweep(v) - offset)

            b = offset
        else:
            mask = y_constraints.mask

            def matvec(v):
                return v - jnp.where(mask, 0.0, sweep(v) - offset)

            b = jnp.where(mask, y_constraints.values, offset)

        solution, _ = bicgstab(
            matvec,
            b,
            x0=y_0,
            tol=0.0,
            atol=self._tol,
            maxiter=self._max_iterations,
        )
        return solution


class ThreePointCentralDifferenceMethod(NumericalDifferentiator):
    """Second-order three-point central differences.

    Interior vertices use the standard central stencil; boundary
    vertices use zero halos (first derivative) or Neumann-synthesized
    ghost vertices (second derivative and Jacobi sweeps), with optional
    constraint overrides on the boundary derivative values — the same
    discretization as the reference's concrete differentiator
    (numerical_differentiator.py:999-1242), expressed as pure selects.
    """

    def _derivative(
        self,
        y: jax.Array,
        d_x: float,
        x_axis: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        n = y.shape[x_axis]
        if n <= 2:
            raise ValueError(
                f"y must contain at least 3 points along x-axis ({x_axis})"
            )

        halo_shape = list(y.shape)
        halo_shape[x_axis] = 1
        halo = jnp.zeros(halo_shape, y.dtype)
        y_ext = jnp.concatenate([halo, y, halo], axis=x_axis)

        derivative = (
            _shifted(y_ext, x_axis, 2, n) - _shifted(y_ext, x_axis, 0, n)
        ) / (2.0 * d_x)

        if constraint_pair is not None:
            for side, constraint in enumerate(constraint_pair):
                if constraint is None:
                    continue
                face = _face(derivative, x_axis, side)
                derivative = _set_face(
                    derivative, x_axis, side, constraint.apply(face)
                )
        return derivative

    def _second_derivative(
        self,
        y: jax.Array,
        d_x1: float,
        d_x2: float,
        x_axis1: int,
        x_axis2: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        if x_axis1 != x_axis2:
            first = self._derivative(y, d_x1, x_axis1, constraint_pair)
            return self._derivative(first, d_x2, x_axis2, None)

        n = y.shape[x_axis1]
        if n <= 2:
            raise ValueError(
                f"y must contain at least 3 points along x-axis "
                f"({x_axis1})"
            )
        y_ext = self._extend_with_halos(y, x_axis1, d_x1, constraint_pair)
        y_prev = _shifted(y_ext, x_axis1, 0, n)
        y_curr = _shifted(y_ext, x_axis1, 1, n)
        y_next = _shifted(y_ext, x_axis1, 2, n)
        return (y_next - 2.0 * y_curr + y_prev) / (d_x1 * d_x2)

    def _next_anti_laplacian_estimate(
        self,
        y_hat: jax.Array,
        laplacian: jax.Array,
        mesh: Mesh,
        constraints,
    ) -> jax.Array:
        if min(y_hat.shape[:-1]) <= 2:
            raise ValueError(
                "y must contain at least 3 points along all x axes"
            )

        cs = mesh.coordinate_system_type
        d_x_sqr = [d**2 for d in mesh.d_x]
        r = r_sqr = phi = sin_phi = r_sqr_sin_phi_sqr = None
        if cs != CoordinateSystem.CARTESIAN:
            r = self._grid(mesh, 0)
            r_sqr = r**2
            if cs == CoordinateSystem.SPHERICAL:
                phi = self._grid(mesh, 2)
                sin_phi = jnp.sin(phi)
                r_sqr_sin_phi_sqr = r_sqr * sin_phi**2

        numerator = -laplacian
        for axis, d_x in enumerate(mesh.d_x):
            n = y_hat.shape[axis]
            y_ext = self._extend_with_halos(
                y_hat, axis, d_x, constraints[axis]
            )
            y_prev = _shifted(y_ext, axis, 0, n)
            y_next = _shifted(y_ext, axis, 2, n)
            neighbor_sum = (y_prev + y_next) / d_x_sqr[axis]

            if cs == CoordinateSystem.CARTESIAN:
                numerator += neighbor_sum
            elif cs == CoordinateSystem.SPHERICAL:
                if axis == 0:
                    numerator += neighbor_sum + (y_next - y_prev) / (
                        d_x * r
                    )
                elif axis == 1:
                    numerator += neighbor_sum / r_sqr_sin_phi_sqr
                else:
                    numerator += (
                        neighbor_sum
                        + jnp.cos(phi)
                        * (y_next - y_prev)
                        / (2.0 * d_x * sin_phi)
                    ) / r_sqr
            else:  # polar / cylindrical
                if axis == 0:
                    numerator += neighbor_sum + (y_next - y_prev) / (
                        2.0 * d_x * r
                    )
                elif axis == 1:
                    numerator += neighbor_sum / r_sqr
                else:
                    numerator += neighbor_sum

        if cs == CoordinateSystem.CARTESIAN:
            denominator = sum(2.0 / d for d in d_x_sqr)
        elif cs == CoordinateSystem.SPHERICAL:
            denominator = (
                2.0 / d_x_sqr[0]
                + 2.0 / (d_x_sqr[1] * r_sqr_sin_phi_sqr)
                + 2.0 / (d_x_sqr[2] * r_sqr)
            )
        else:
            denominator = 2.0 / d_x_sqr[0] + 2.0 / (d_x_sqr[1] * r_sqr)
            if cs == CoordinateSystem.CYLINDRICAL:
                denominator = denominator + 2.0 / d_x_sqr[2]

        return numerator / denominator

    @staticmethod
    def _extend_with_halos(
        y: jax.Array,
        x_axis: int,
        d_x: float,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        """Appends ghost vertices along ``x_axis``.

        Where a derivative boundary constraint exists, the ghost value is
        the one-inward vertex value offset by ``±2·d_x`` times the
        constrained normal derivative (so the central difference at the
        boundary reproduces the Neumann condition); elsewhere it is zero.
        """
        lower_adjacent = _inner_adjacent(y, x_axis, 0)
        upper_adjacent = _inner_adjacent(y, x_axis, 1)
        lower_halo = jnp.zeros_like(lower_adjacent)
        upper_halo = jnp.zeros_like(upper_adjacent)

        if constraint_pair is not None:
            if constraint_pair.lower is not None:
                lower_halo = constraint_pair.lower.multiply_and_add(
                    lower_adjacent, -2.0 * d_x, lower_halo
                )
            if constraint_pair.upper is not None:
                upper_halo = constraint_pair.upper.multiply_and_add(
                    upper_adjacent, 2.0 * d_x, upper_halo
                )

        return jnp.concatenate([lower_halo, y, upper_halo], axis=x_axis)


class FivePointCentralDifferenceMethod(NumericalDifferentiator):
    """Fourth-order five-point central differences — an accuracy
    extension beyond the reference, whose only concrete differentiator
    is the second-order three-point method
    (/root/reference/pararealml/operators/fdm/
    numerical_differentiator.py:999-1242).

    Vertices two or more points from every boundary use the classic
    five-point fourth-order stencils; the outermost two vertices on each
    side fall back to the exact three-point boundary treatment of
    :class:`ThreePointCentralDifferenceMethod` — zero halos for the
    first derivative, Neumann-synthesized ghost vertices for the second
    — so boundary-condition semantics (including constraint overrides on
    the boundary faces) are identical between the two methods and
    switching differentiators never changes how a problem's boundary
    conditions are interpreted. On smooth problems the interior
    truncation error drops from O(d_x^2) to O(d_x^4), buying coarser
    grids at matched accuracy; the overall solve order remains limited
    by the second-order boundary closure.

    The full coordinate-system-aware vector calculus of the base class
    (gradient through vector Laplacian, all four coordinate systems)
    rides on these primitives unchanged.
    """

    # boundary halos are synthesized exactly as in the three-point
    # method (the boundary closure IS the three-point one)
    _extend_with_halos = staticmethod(
        ThreePointCentralDifferenceMethod._extend_with_halos
    )

    @staticmethod
    def _check_min_points(n: int, x_axis: int):
        if n <= 4:
            raise ValueError(
                f"y must contain at least 5 points along x-axis ({x_axis})"
            )

    def _derivative(
        self,
        y: jax.Array,
        d_x: float,
        x_axis: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        n = y.shape[x_axis]
        self._check_min_points(n, x_axis)

        halo_shape = list(y.shape)
        halo_shape[x_axis] = 1
        halo = jnp.zeros(halo_shape, y.dtype)
        y_ext = jnp.concatenate([halo, y, halo], axis=x_axis)
        second_order = (
            _shifted(y_ext, x_axis, 2, n) - _shifted(y_ext, x_axis, 0, n)
        ) / (2.0 * d_x)

        interior = n - 4  # centers 2 .. n-3 need no halo
        fourth_order = (
            _shifted(y, x_axis, 0, interior)
            - 8.0 * _shifted(y, x_axis, 1, interior)
            + 8.0 * _shifted(y, x_axis, 3, interior)
            - _shifted(y, x_axis, 4, interior)
        ) / (12.0 * d_x)

        derivative = jnp.concatenate(
            [
                _face(second_order, x_axis, 0, 2),
                fourth_order,
                _face(second_order, x_axis, 1, 2),
            ],
            axis=x_axis,
        )

        if constraint_pair is not None:
            for side, constraint in enumerate(constraint_pair):
                if constraint is None:
                    continue
                face = _face(derivative, x_axis, side)
                derivative = _set_face(
                    derivative, x_axis, side, constraint.apply(face)
                )
        return derivative

    def _second_derivative(
        self,
        y: jax.Array,
        d_x1: float,
        d_x2: float,
        x_axis1: int,
        x_axis2: int,
        constraint_pair: Optional[BoundaryConstraintPair],
    ) -> jax.Array:
        if x_axis1 != x_axis2:
            first = self._derivative(y, d_x1, x_axis1, constraint_pair)
            return self._derivative(first, d_x2, x_axis2, None)

        n = y.shape[x_axis1]
        self._check_min_points(n, x_axis1)

        y_ext = self._extend_with_halos(y, x_axis1, d_x1, constraint_pair)
        y_prev = _shifted(y_ext, x_axis1, 0, n)
        y_curr = _shifted(y_ext, x_axis1, 1, n)
        y_next = _shifted(y_ext, x_axis1, 2, n)
        second_order = (y_next - 2.0 * y_curr + y_prev) / (d_x1 * d_x2)

        interior = n - 4
        fourth_order = (
            -_shifted(y, x_axis1, 0, interior)
            + 16.0 * _shifted(y, x_axis1, 1, interior)
            - 30.0 * _shifted(y, x_axis1, 2, interior)
            + 16.0 * _shifted(y, x_axis1, 3, interior)
            - _shifted(y, x_axis1, 4, interior)
        ) / (12.0 * d_x1 * d_x2)

        return jnp.concatenate(
            [
                _face(second_order, x_axis1, 0, 2),
                fourth_order,
                _face(second_order, x_axis1, 1, 2),
            ],
            axis=x_axis1,
        )

    def _next_anti_laplacian_estimate(
        self,
        y_hat: jax.Array,
        laplacian: jax.Array,
        mesh: Mesh,
        constraints,
    ) -> jax.Array:
        # Jacobi sweeps invert the SECOND-order Laplacian: the
        # fourth-order stencil is not diagonally dominant (off-diagonal
        # weights sum to 34/12 against a 30/12 diagonal), so plain
        # Jacobi on it need not converge; the anti-Laplacian is a
        # tolerance-bounded solve either way, matching the reference's
        # second-order inversion semantics.
        return ThreePointCentralDifferenceMethod._next_anti_laplacian_estimate(  # noqa: E501
            self, y_hat, laplacian, mesh, constraints
        )
