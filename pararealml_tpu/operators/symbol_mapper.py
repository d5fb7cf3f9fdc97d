"""Generic symbolic-to-numeric mapping.

Capability match for /root/reference/pararealml/operators/symbol_mapper.py:
23-271: parses the symbol-name grammar produced by
:class:`~pararealml_tpu.differential_equation.Symbols`
(``y-gradient_1_0`` etc.), compiles the right-hand sides once per LHS type
with :func:`~pararealml_tpu.expression.compile_expressions` into
``jax.numpy`` operations, and substitutes per-symbol
evaluation closures. The compiled evaluators are pure and jit-traceable, so
a whole FDM right-hand side fuses into one XLA computation.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Optional, Sequence, TypeVar, \
    Union

import numpy as np

from pararealml_tpu.differential_equation import LHS, DifferentialEquation
from pararealml_tpu.expression import Symbol, compile_expressions

SymbolMapArg = TypeVar("SymbolMapArg")
SymbolMapValue = TypeVar("SymbolMapValue")
SymbolMapFunction = Callable[[SymbolMapArg], SymbolMapValue]


class SymbolMapper(Generic[SymbolMapArg, SymbolMapValue]):
    """Maps the symbols of a differential equation system to numerical
    evaluation functions and compiles the system's right-hand sides."""

    def __init__(self, diff_eq: DifferentialEquation):
        self._diff_eq = diff_eq
        self._symbol_map = self.create_symbol_map()

        eq_sys = diff_eq.symbolic_equation_system
        self._rhs_functions: Dict[
            Optional[LHS],
            Callable[[SymbolMapArg], Sequence[SymbolMapValue]],
        ] = {None: self.create_rhs_map_function(range(len(eq_sys.rhs)))}
        for lhs_type in LHS:
            self._rhs_functions[lhs_type] = self.create_rhs_map_function(
                eq_sys.equation_indices_by_type(lhs_type)
            )

    # -- abstract per-symbol map-function factories ------------------------

    def t_map_function(self) -> SymbolMapFunction:
        """A function mapping the ``t`` symbol to a numerical value."""
        raise NotImplementedError

    def y_map_function(self, y_ind: int) -> SymbolMapFunction:
        """A function mapping a component of y to a numerical value."""
        raise NotImplementedError

    def x_map_function(self, x_axis: int) -> SymbolMapFunction:
        """A function mapping a spatial coordinate to a numerical value."""
        raise NotImplementedError

    def y_gradient_map_function(
        self, y_ind: int, x_axis: int
    ) -> SymbolMapFunction:
        """A function mapping a gradient component to a numerical value."""
        raise NotImplementedError

    def y_hessian_map_function(
        self, y_ind: int, x_axis1: int, x_axis2: int
    ) -> SymbolMapFunction:
        """A function mapping a Hessian component to a numerical value."""
        raise NotImplementedError

    def y_divergence_map_function(
        self,
        y_indices: Sequence[int],
        indices_contiguous: Union[bool, np.bool_],
    ) -> SymbolMapFunction:
        """A function mapping a divergence to a numerical value."""
        raise NotImplementedError

    def y_curl_map_function(
        self,
        y_indices: Sequence[int],
        indices_contiguous: Union[bool, np.bool_],
        curl_ind: int,
    ) -> SymbolMapFunction:
        """A function mapping a curl component to a numerical value."""
        raise NotImplementedError

    def y_laplacian_map_function(self, y_ind: int) -> SymbolMapFunction:
        """A function mapping a scalar-Laplacian component to a numerical
        value."""
        raise NotImplementedError

    def y_vector_laplacian_map_function(
        self,
        y_indices: Sequence[int],
        indices_contiguous: Union[bool, np.bool_],
        vector_laplacian_ind: int,
    ) -> SymbolMapFunction:
        """A function mapping a vector-Laplacian component to a numerical
        value."""
        raise NotImplementedError

    # -- compilation -------------------------------------------------------

    def create_symbol_map(
        self,
    ) -> Dict[Symbol, SymbolMapFunction]:
        """Builds the map from every symbol used in the equation system to
        its evaluation closure by parsing the symbol-name grammar."""
        symbol_map: Dict[Symbol, SymbolMapFunction] = {}

        x_dimension = self._diff_eq.x_dimension
        eq_sys = self._diff_eq.symbolic_equation_system
        all_symbols = set().union(
            *[rhs.free_symbols for rhs in eq_sys.rhs]
        )

        for symbol in all_symbols:
            tokens = symbol.name.split("_")
            prefix = tokens[0]
            indices = [int(t) for t in tokens[1:]]

            if prefix == "t":
                fn = self.t_map_function()
            elif prefix == "y":
                fn = self.y_map_function(*indices)
            elif prefix == "x":
                fn = self.x_map_function(*indices)
            elif prefix == "y-gradient":
                fn = self.y_gradient_map_function(*indices)
            elif prefix == "y-hessian":
                fn = self.y_hessian_map_function(*indices)
            elif prefix == "y-laplacian":
                fn = self.y_laplacian_map_function(*indices)
            elif prefix in (
                "y-divergence",
                "y-curl",
                "y-vector-laplacian",
            ):
                contiguous = all(
                    indices[i] + 1 == indices[i + 1]
                    for i in range(len(indices) - 1)
                )
                if prefix == "y-divergence":
                    fn = self.y_divergence_map_function(indices, contiguous)
                elif prefix == "y-curl":
                    if x_dimension == 2:
                        fn = self.y_curl_map_function(indices, contiguous, 0)
                    else:
                        fn = self.y_curl_map_function(
                            indices[:-1], contiguous, indices[-1]
                        )
                else:
                    fn = self.y_vector_laplacian_map_function(
                        indices[:-1], contiguous, indices[-1]
                    )
            else:
                raise ValueError(f"unrecognized symbol {symbol.name}")

            symbol_map[symbol] = fn

        return symbol_map

    def create_rhs_map_function(
        self, indices: Sequence[int]
    ) -> Callable[[SymbolMapArg], Sequence[SymbolMapValue]]:
        """Compiles the selected right-hand sides into a single
        ``jax.numpy``-backed callable (compiled once), fed by the
        per-symbol closures."""
        rhs = self._diff_eq.symbolic_equation_system.rhs

        selected_rhs = [rhs[i] for i in indices]
        selected_symbols = sorted(
            set().union(*[r.free_symbols for r in selected_rhs], set()),
            key=lambda s: s.name,
        )
        subst_functions = [self._symbol_map[s] for s in selected_symbols]
        rhs_lambda = compile_expressions(selected_rhs, selected_symbols)

        def rhs_map_function(
            arg: SymbolMapArg,
        ) -> Sequence[SymbolMapValue]:
            return rhs_lambda([fn(arg) for fn in subst_functions])

        return rhs_map_function

    def map(
        self, arg: SymbolMapArg, lhs_type: Optional[LHS] = None
    ) -> Sequence[SymbolMapValue]:
        """Evaluates the right-hand sides of the (optionally LHS-filtered)
        equation system for the given argument."""
        return self._rhs_functions[lhs_type](arg)
