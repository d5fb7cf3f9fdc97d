"""Symbolic definition of differential equation systems.

Capability match for the reference's symbolic layer
(/root/reference/pararealml/differential_equation.py:10-850): a
coordinate-system-agnostic symbol vocabulary (``t``, ``y_i``, ``x_j``,
gradients, Hessians, divergence, curl, Laplacians), an LHS-typed equation
system, a validating ``DifferentialEquation`` base class, and the same 13
built-in equations. The symbols carry the same name grammar
(``y-gradient_1_0`` etc.) because the symbol mappers parse it. The
symbols and right-hand sides are :mod:`pararealml_tpu.expression` trees
(the reference uses SymPy), which everything downstream compiles to
``jax.numpy``.
"""

from __future__ import annotations

from copy import copy, deepcopy
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from pararealml_tpu.expression import Expr, Symbol, as_expr, symarray


class Symbols:
    """The full symbol vocabulary available for defining a differential
    equation system with a given number of spatial dimensions and unknowns.
    """

    def __init__(self, x_dimension: int, y_dimension: int):
        self._t = Symbol("t")
        self._y = symarray("y", (y_dimension,))

        self._x = None
        self._y_gradient = None
        self._y_hessian = None
        self._y_divergence = None
        self._y_curl = None
        self._y_laplacian = None
        self._y_vector_laplacian = None

        if x_dimension:
            self._x = symarray("x", (x_dimension,))
            self._y_gradient = symarray(
                "y-gradient", (y_dimension, x_dimension)
            )
            self._y_hessian = symarray(
                "y-hessian", (y_dimension, x_dimension, x_dimension)
            )
            self._y_divergence = symarray(
                "y-divergence", (y_dimension,) * x_dimension
            )
            if 2 <= x_dimension <= 3:
                curl_shape = (y_dimension,) * x_dimension
                if x_dimension == 3:
                    curl_shape = curl_shape + (x_dimension,)
                self._y_curl = symarray("y-curl", curl_shape)
            self._y_laplacian = symarray("y-laplacian", (y_dimension,))
            self._y_vector_laplacian = symarray(
                "y-vector-laplacian",
                ((y_dimension,) * x_dimension) + (x_dimension,),
            )

    @property
    def t(self) -> Symbol:
        """The temporal coordinate symbol."""
        return self._t

    @property
    def y(self) -> np.ndarray:
        """Symbols for the components of the solution."""
        return copy(self._y)

    @property
    def x(self) -> Optional[np.ndarray]:
        """Symbols for the spatial coordinates (None for ODEs)."""
        return copy(self._x)

    @property
    def y_gradient(self) -> Optional[np.ndarray]:
        """Symbols ``y_gradient[i, j]`` for d y_i / d x_j."""
        return copy(self._y_gradient)

    @property
    def y_hessian(self) -> Optional[np.ndarray]:
        """Symbols ``y_hessian[i, j, k]`` for d^2 y_i / (d x_j d x_k)."""
        return copy(self._y_hessian)

    @property
    def y_divergence(self) -> Optional[np.ndarray]:
        """Symbols for the divergence of vector fields assembled from
        components of y (indexed by the component indices)."""
        return copy(self._y_divergence)

    @property
    def y_curl(self) -> Optional[np.ndarray]:
        """Symbols for the curl of vector fields assembled from components
        of y; scalar in 2D, with a trailing component axis in 3D."""
        return copy(self._y_curl)

    @property
    def y_laplacian(self) -> Optional[np.ndarray]:
        """Symbols for the scalar Laplacian of each component of y."""
        return copy(self._y_laplacian)

    @property
    def y_vector_laplacian(self) -> Optional[np.ndarray]:
        """Symbols for the vector Laplacian, with a trailing component
        axis."""
        return copy(self._y_vector_laplacian)


class LHS(Enum):
    """The types of the left-hand side of an equation in a system."""

    D_Y_OVER_D_T = 0
    Y = 1
    Y_LAPLACIAN = 2


class SymbolicEquationSystem:
    """A system of symbolic equations with typed left-hand sides."""

    def __init__(
        self,
        rhs: Union[Sequence[Expr], np.ndarray],
        lhs_types: Optional[Sequence[LHS]] = None,
    ):
        if len(rhs) < 1:
            raise ValueError("number of equations must be greater than 0")

        if lhs_types is None:
            lhs_types = [LHS.D_Y_OVER_D_T] * len(rhs)
        if len(rhs) != len(lhs_types):
            raise ValueError(
                f"length of right-hand side ({len(rhs)}) must match length "
                f"of left-hand side ({len(lhs_types)})"
            )

        self._rhs = [as_expr(expression) for expression in rhs]
        self._lhs_types = list(lhs_types)

        self._indices_by_type: Dict[LHS, List[int]] = {t: [] for t in LHS}
        for i, lhs_type in enumerate(self._lhs_types):
            self._indices_by_type[lhs_type].append(i)

    @property
    def rhs(self) -> Sequence[Expr]:
        """The right-hand-side expressions."""
        return copy(self._rhs)

    @property
    def lhs_types(self) -> Sequence[LHS]:
        """The left-hand-side type of each equation."""
        return copy(self._lhs_types)

    def equation_indices_by_type(self, lhs_type: LHS) -> Sequence[int]:
        """The indices of the equations with the given LHS type."""
        return copy(self._indices_by_type[lhs_type])


class DifferentialEquation:
    """Base class for time-dependent differential equation systems.

    Subclasses implement :attr:`symbolic_equation_system`; construction
    validates that the expressions only use the legal symbol vocabulary and
    that the LHS typing is consistent with the problem class (ODE systems
    must be purely D_Y_OVER_D_T, PDE systems need at least one such
    equation).
    """

    def __init__(
        self,
        x_dimension: int,
        y_dimension: int,
        all_vector_field_indices: Optional[Sequence[Sequence[int]]] = None,
    ):
        if x_dimension < 0:
            raise ValueError(
                f"number of x dimensions ({x_dimension}) must be "
                "non-negative"
            )
        if y_dimension < 1:
            raise ValueError(
                f"number of y dimensions ({y_dimension}) must be at least 1"
            )
        if all_vector_field_indices:
            for indices in all_vector_field_indices:
                if len(indices) != x_dimension:
                    raise ValueError(
                        f"length of vector field indices {indices} must "
                        f"match x dimensions ({x_dimension})"
                    )
                if any(not (0 <= i < y_dimension) for i in indices):
                    raise ValueError(
                        "all indices must be non-negative and less than "
                        f"the number of y dimensions ({y_dimension})"
                    )

        self._x_dimension = x_dimension
        self._y_dimension = y_dimension
        self._all_vector_field_indices = deepcopy(all_vector_field_indices)
        self._symbols = Symbols(x_dimension, y_dimension)
        self._validate_equations()

    @property
    def x_dimension(self) -> int:
        """The number of spatial dimensions (0 for ODEs)."""
        return self._x_dimension

    @property
    def y_dimension(self) -> int:
        """The number of components of the solution."""
        return self._y_dimension

    @property
    def symbols(self) -> Symbols:
        """The legal symbol vocabulary for this equation."""
        return self._symbols

    @property
    def all_vector_field_indices(
        self,
    ) -> Optional[Sequence[Sequence[int]]]:
        """Index groups of y components that form vector fields."""
        return deepcopy(self._all_vector_field_indices)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        """The symbolic equation system defining the dynamics."""
        raise NotImplementedError

    def _validate_equations(self):
        eq_sys = self.symbolic_equation_system
        if len(eq_sys.rhs) != self._y_dimension:
            raise ValueError(
                f"number of equations ({len(eq_sys.rhs)}) must match number "
                f"of y dimensions ({self._y_dimension})"
            )

        legal = {self._symbols.t, *self._symbols.y}
        if self._x_dimension:
            sym = self._symbols
            legal.update(sym.x)
            legal.update(sym.y_gradient.flatten())
            legal.update(sym.y_hessian.flatten())
            legal.update(sym.y_divergence.flatten())
            if sym.y_curl is not None:
                legal.update(np.atleast_1d(sym.y_curl).flatten())
            legal.update(sym.y_laplacian)
            legal.update(sym.y_vector_laplacian.flatten())

        for i, rhs in enumerate(eq_sys.rhs):
            free = rhs.free_symbols
            if not free.issubset(legal):
                raise ValueError(
                    f"invalid symbol in right-hand side symbols ({free}) "
                    f"of equation {i}"
                )

        d_y_indices = eq_sys.equation_indices_by_type(LHS.D_Y_OVER_D_T)
        if self._x_dimension:
            if not d_y_indices:
                raise ValueError(
                    "at least one equation's left-hand side must be of "
                    "type D_Y_OVER_D_T"
                )
        elif len(d_y_indices) != self._y_dimension:
            raise ValueError(
                "ordinary differential equation systems can only contain "
                "equations with D_Y_OVER_D_T type left-hand sides"
            )


class PopulationGrowthEquation(DifferentialEquation):
    """Exponential population growth: y' = r * y."""

    def __init__(self, r: float = 0.01):
        self._r = r
        super().__init__(0, 1)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        return SymbolicEquationSystem([self._r * self._symbols.y[0]])


class LotkaVolterraEquation(DifferentialEquation):
    """Prey-predator population dynamics."""

    def __init__(
        self,
        alpha: float = 2.0,
        beta: float = 0.04,
        gamma: float = 1.06,
        delta: float = 0.02,
    ):
        if min(alpha, beta, gamma, delta) < 0.0:
            raise ValueError("all coefficients must be non-negative")
        self._alpha, self._beta = alpha, beta
        self._gamma, self._delta = gamma, delta
        super().__init__(0, 2)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        prey, pred = self._symbols.y
        return SymbolicEquationSystem(
            [
                self._alpha * prey - self._beta * prey * pred,
                self._delta * prey * pred - self._gamma * pred,
            ]
        )


class LorenzEquation(DifferentialEquation):
    """The Lorenz system modelling atmospheric convection."""

    def __init__(
        self, sigma: float = 10.0, rho: float = 28.0, beta: float = 8.0 / 3.0
    ):
        if min(sigma, rho, beta) < 0.0:
            raise ValueError("all coefficients must be non-negative")
        self._sigma, self._rho, self._beta = sigma, rho, beta
        super().__init__(0, 3)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        c, h, v = self._symbols.y
        return SymbolicEquationSystem(
            [
                self._sigma * (h - c),
                c * (self._rho - v) - h,
                c * h - self._beta * v,
            ]
        )


class SIREquation(DifferentialEquation):
    """The SIR epidemiological compartment model."""

    def __init__(self, beta: float = 0.2, gamma: float = 0.1):
        if beta < 0.0 or gamma < 0.0:
            raise ValueError("beta and gamma must be non-negative")
        self._beta, self._gamma = beta, gamma
        super().__init__(0, 3)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        s, i, r = self._symbols.y
        n = s + i + r
        infection = self._beta * s * i / n
        recovery = self._gamma * i
        return SymbolicEquationSystem(
            [-infection, infection - recovery, recovery]
        )


class VanDerPolEquation(DifferentialEquation):
    """The Van der Pol oscillator in first-order form."""

    def __init__(self, mu: float = 1.0):
        if mu < 0.0:
            raise ValueError("mu must be non-negative")
        self._mu = mu
        super().__init__(0, 2)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        u, v = self._symbols.y
        return SymbolicEquationSystem([v, self._mu * (1.0 - u**2) * v - u])


class NBodyGravitationalEquation(DifferentialEquation):
    """Newtonian gravitational N-body dynamics in 2 or 3 dimensions.

    The state layout matches the reference
    (differential_equation.py:510-605): first all positions (object-major),
    then all velocities.
    """

    def __init__(
        self, n_dims: int, masses: Sequence[float], g: float = 6.6743e-11
    ):
        if not 2 <= n_dims <= 3:
            raise ValueError(
                f"number of dimensions ({n_dims}) must be either 2 or 3"
            )
        if len(masses) < 2:
            raise ValueError(
                f"number of masses ({len(masses)}) must be at least 2"
            )
        if min(masses) <= 0.0:
            raise ValueError(f"all masses ({masses}) must be greater than 0")

        self._dims = n_dims
        self._masses = tuple(masses)
        self._g = g
        super().__init__(0, 2 * len(masses) * n_dims)

    @property
    def spatial_dimension(self) -> int:
        """The number of spatial dimensions of the motion."""
        return self._dims

    @property
    def masses(self) -> Tuple[float, ...]:
        """The masses of the objects."""
        return self._masses

    @property
    def n_objects(self) -> int:
        """The number of objects."""
        return len(self._masses)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        y = self._symbols.y
        n, d = self.n_objects, self._dims
        n_pos = n * d

        positions = [y[i * d: (i + 1) * d] for i in range(n)]
        accelerations = [
            np.zeros(d, dtype=object) for _ in range(n)
        ]
        # accelerate each object by g * m_other / r^3 * displacement
        # directly: the force g * m_i * m_j overflows float32 for
        # astronomical masses, and expressions are evaluated as written
        for i in range(n):
            for j in range(i + 1, n):
                displacement = positions[j] - positions[i]
                distance = sum(c**2 for c in displacement) ** 0.5
                inverse_cube = 1.0 / distance**3
                accelerations[i] = accelerations[i] + (
                    self._g * self._masses[j] * inverse_cube
                ) * displacement
                accelerations[j] = accelerations[j] - (
                    self._g * self._masses[i] * inverse_cube
                ) * displacement

        rhs = np.empty(2 * n_pos, dtype=object)
        rhs[:n_pos] = y[n_pos:]
        for i in range(n):
            rhs[n_pos + i * d: n_pos + (i + 1) * d] = accelerations[i]
        return SymbolicEquationSystem(rhs)


class DiffusionEquation(DifferentialEquation):
    """Isotropic diffusion: y_t = d * Laplacian(y)."""

    def __init__(self, x_dimension: int, d: float = 1.0):
        if x_dimension <= 0:
            raise ValueError(
                f"number of x dimensions ({x_dimension}) must be at least 1"
            )
        self._d = d
        super().__init__(x_dimension, 1)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        return SymbolicEquationSystem(
            [self._d * self._symbols.y_laplacian[0]]
        )


class ConvectionDiffusionEquation(DifferentialEquation):
    """Diffusion with a constant convection velocity field."""

    def __init__(
        self, x_dimension: int, velocity: Sequence[float], d: float = 1.0
    ):
        if x_dimension <= 0:
            raise ValueError(
                f"number of x dimensions ({x_dimension}) must be at least 1"
            )
        if len(velocity) != x_dimension:
            raise ValueError(
                f"length of the velocity vector ({len(velocity)}) must "
                f"match number of x dimensions ({x_dimension})"
            )
        self._velocity = list(velocity)
        self._d = d
        super().__init__(x_dimension, 1)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        sym = self._symbols
        advection = sum(
            v * g for v, g in zip(self._velocity, sym.y_gradient[0, :])
        )
        return SymbolicEquationSystem(
            [self._d * sym.y_laplacian[0] - advection]
        )


class WaveEquation(DifferentialEquation):
    """The wave equation in first-order (displacement, velocity) form."""

    def __init__(self, x_dimension: int, c: float = 1.0):
        if x_dimension <= 0:
            raise ValueError(
                f"number of x dimensions ({x_dimension}) must be at least 1"
            )
        self._c = c
        super().__init__(x_dimension, 2)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        sym = self._symbols
        return SymbolicEquationSystem(
            [sym.y[1], self._c**2 * sym.y_laplacian[0]]
        )


class CahnHilliardEquation(DifferentialEquation):
    """The Cahn-Hilliard phase-separation system (mixed LHS types)."""

    def __init__(self, x_dimension: int, d: float = 0.1, gamma: float = 0.01):
        if x_dimension <= 0:
            raise ValueError(
                f"number of x dimensions ({x_dimension}) must be at least 1"
            )
        self._d, self._gamma = d, gamma
        super().__init__(x_dimension, 2)

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        sym = self._symbols
        c = sym.y[0]
        return SymbolicEquationSystem(
            [
                self._d * sym.y_laplacian[1],
                c**3 - c - self._gamma * sym.y_laplacian[0],
            ],
            [LHS.D_Y_OVER_D_T, LHS.Y],
        )


class BurgersEquation(DifferentialEquation):
    """The viscous Burgers system."""

    def __init__(self, x_dimension: int, re: float = 4000.0):
        if x_dimension <= 0:
            raise ValueError(
                f"number of x dimensions ({x_dimension}) must be at least 1"
            )
        self._re = re
        super().__init__(
            x_dimension, x_dimension, [tuple(range(x_dimension))]
        )

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        sym = self._symbols
        viscosity = 1.0 / self._re
        return SymbolicEquationSystem(
            [
                viscosity * sym.y_laplacian[i]
                - sum(
                    sym.y[j] * sym.y_gradient[i, j]
                    for j in range(self._x_dimension)
                )
                for i in range(self._x_dimension)
            ]
        )


class ShallowWaterEquation(DifferentialEquation):
    """Non-conservative 2D shallow-water equations."""

    def __init__(
        self,
        h: float,
        b: float = 0.01,
        v: float = 0.1,
        f: float = 0.0,
        g: float = 9.80665,
    ):
        self._h, self._b, self._v, self._f, self._g = h, b, v, f, g
        super().__init__(2, 3, [(1, 2)])

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        sym = self._symbols
        eta = sym.y[0]
        u, w = sym.y[1], sym.y[2]
        grad = sym.y_gradient
        return SymbolicEquationSystem(
            [
                -self._h * sym.y_divergence[1, 2]
                - eta * grad[1, 0]
                - u * grad[0, 0]
                - eta * grad[2, 1]
                - w * grad[0, 1],
                self._v * sym.y_laplacian[1]
                - u * grad[1, 0]
                - w * grad[1, 1]
                - self._g * grad[0, 0]
                - self._b * u
                + self._f * w,
                self._v * sym.y_laplacian[2]
                - u * grad[2, 0]
                - w * grad[2, 1]
                - self._g * grad[0, 1]
                - self._b * w
                - self._f * u,
            ]
        )


class NavierStokesEquation(DifferentialEquation):
    """2D incompressible Navier-Stokes in vorticity-stream-function form.

    y = (vorticity, stream function, u, v) with the mixed LHS typing of the
    reference (differential_equation.py:822-850).
    """

    def __init__(self, re: float = 4000.0):
        self._re = re
        super().__init__(2, 4, [(2, 3)])

    @property
    def symbolic_equation_system(self) -> SymbolicEquationSystem:
        sym = self._symbols
        vorticity = sym.y[0]
        grad = sym.y_gradient
        velocity = sym.y[2:]
        return SymbolicEquationSystem(
            [
                (1.0 / self._re) * sym.y_laplacian[0]
                - (velocity[0] * grad[0, 0] + velocity[1] * grad[0, 1]),
                -vorticity,
                grad[1, 1],
                -grad[1, 0],
            ],
            [LHS.D_Y_OVER_D_T, LHS.Y_LAPLACIAN, LHS.Y, LHS.Y],
        )
