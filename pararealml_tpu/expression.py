"""A small symbolic expression language for equation right-hand sides.

Equations are written with the symbols of
:class:`~pararealml_tpu.differential_equation.Symbols` combined by
arithmetic (``+ - * / **`` and unary minus) and the elementary functions
below. An expression is an immutable tree; :func:`compile_expressions`
walks it once at trace time into ``jax.numpy`` operations, so a whole
right-hand side fuses into one XLA computation, and :func:`degree` is the
polynomial-degree query the affine-propagator check needs.

Expressions are evaluated as written, without simplification, so
intermediate values must stay inside the range of the dtype they run in
(float32 on accelerators). Symbols compare and hash by name, so symbols
built twice from the same name are the same symbol. Expressions from other symbolic libraries
(e.g. SymPy) are not accepted: combining one with an :class:`Expr`
raises ``TypeError``.
"""

from __future__ import annotations

import numbers
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, \
    Sequence, Tuple

import jax.numpy as jnp
import numpy as np

_FUNCTIONS: Dict[str, Callable] = {
    "sqrt": jnp.sqrt,
    "exp": jnp.exp,
    "log": jnp.log,
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tanh": jnp.tanh,
}

_BINARY: Dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a**b,
}

_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", "pow": "**"}


class Expr:
    """A node of an expression tree: an operation name and its operands
    (child expressions, a constant's value, or a symbol's name)."""

    __slots__ = ("_op", "_args", "_hash")

    def __init__(self, op: str, args: Tuple):
        self._op = op
        self._args = args
        self._hash = hash((op, args))

    @property
    def op(self) -> str:
        """The operation: ``"symbol"``, ``"const"``, ``"neg"``, a binary
        operation (``"add"``, ``"sub"``, ``"mul"``, ``"div"``,
        ``"pow"``) or a function name (``"sqrt"``, ``"exp"``, ...)."""
        return self._op

    @property
    def args(self) -> Tuple:
        """The operands of the operation."""
        return self._args

    @property
    def free_symbols(self) -> FrozenSet["Symbol"]:
        """The set of symbols the expression depends on."""
        symbols = set()
        stack = [self]
        while stack:
            node = stack.pop()
            if isinstance(node, Symbol):
                symbols.add(node)
            elif node._op != "const":
                stack.extend(node._args)
        return frozenset(symbols)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Expr)
            and self._hash == other._hash
            and self._op == other._op
            and self._args == other._args
        )

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        if self._op == "symbol":
            return self._args[0]
        if self._op == "const":
            return repr(self._args[0])
        if self._op == "neg":
            return f"(-{self._args[0]!r})"
        if self._op in _INFIX:
            a, b = self._args
            return f"({a!r} {_INFIX[self._op]} {b!r})"
        return f"{self._op}({self._args[0]!r})"

    def __neg__(self) -> "Expr":
        return Expr("neg", (self,))

    def __pos__(self) -> "Expr":
        return self

    def __add__(self, other):
        return _binary("add", self, other)

    def __radd__(self, other):
        return _binary("add", other, self)

    def __sub__(self, other):
        return _binary("sub", self, other)

    def __rsub__(self, other):
        return _binary("sub", other, self)

    def __mul__(self, other):
        return _binary("mul", self, other)

    def __rmul__(self, other):
        return _binary("mul", other, self)

    def __truediv__(self, other):
        return _binary("div", self, other)

    def __rtruediv__(self, other):
        return _binary("div", other, self)

    def __pow__(self, other):
        return _binary("pow", self, other)

    def __rpow__(self, other):
        return _binary("pow", other, self)


class Symbol(Expr):
    """A named variable."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__("symbol", (str(name),))

    @property
    def name(self) -> str:
        """The symbol's name."""
        return self._args[0]


def as_expr(value) -> Expr:
    """Wraps real numbers as constants and passes expressions through;
    anything else (including SymPy objects) raises ``TypeError``."""
    if isinstance(value, Expr):
        return value
    if isinstance(value, numbers.Real) and not isinstance(value, bool):
        if isinstance(value, numbers.Integral):
            return Expr("const", (int(value),))
        return Expr("const", (float(value),))
    raise TypeError(
        f"cannot use an object of type {type(value).__name__} in an "
        "equation; build right-hand sides from the symbols of "
        "DifferentialEquation.symbols, numbers and the functions of "
        "pararealml_tpu.expression (SymPy expressions are not supported)"
    )


def _binary(op: str, left, right):
    if isinstance(left, np.ndarray) or isinstance(right, np.ndarray):
        # let NumPy broadcast the operation over the object array
        return NotImplemented
    try:
        return Expr(op, (as_expr(left), as_expr(right)))
    except TypeError:
        return NotImplemented


def _function(name: str) -> Callable[[object], Expr]:
    def apply(value) -> Expr:
        return Expr(name, (as_expr(value),))

    apply.__name__ = name
    apply.__doc__ = f"The ``{name}`` of an expression."
    return apply


sqrt = _function("sqrt")
exp = _function("exp")
log = _function("log")
sin = _function("sin")
cos = _function("cos")
tanh = _function("tanh")


def symarray(prefix: str, shape: Sequence[int]) -> np.ndarray:
    """An object array of symbols named ``prefix_i_j...`` after their
    indices."""
    array = np.empty(tuple(shape), dtype=object)
    for index in np.ndindex(*array.shape):
        array[index] = Symbol("_".join([prefix, *map(str, index)]))
    return array


def _evaluate(expr: Expr, env: Dict[Symbol, object], memo: Dict):
    key = id(expr)
    if key in memo:
        return memo[key]
    op = expr.op
    if op == "symbol":
        value = env[expr]
    elif op == "const":
        value = expr.args[0]
    elif op == "neg":
        value = -_evaluate(expr.args[0], env, memo)
    elif op in _BINARY:
        value = _BINARY[op](
            _evaluate(expr.args[0], env, memo),
            _evaluate(expr.args[1], env, memo),
        )
    else:
        value = _FUNCTIONS[op](_evaluate(expr.args[0], env, memo))
    memo[key] = value
    return value


def compile_expressions(
    exprs: Sequence[Expr], symbols: Sequence[Symbol]
) -> Callable[[Sequence], List]:
    """Compiles expressions into ``fn(values) -> [value, ...]``, where
    ``values[k]`` is the value of ``symbols[k]``. Constants stay Python
    numbers, so they take the dtype of the arrays they meet; an
    expression that is a bare constant evaluates to that number."""
    exprs = [as_expr(e) for e in exprs]
    symbols = list(symbols)
    missing = set().union(*[e.free_symbols for e in exprs]) - set(symbols)
    if missing:
        raise ValueError(
            f"no value given for symbols {sorted(map(str, missing))}"
        )

    def evaluate(values: Sequence) -> List:
        env = dict(zip(symbols, values))
        memo: Dict[int, object] = {}
        return [_evaluate(e, env, memo) for e in exprs]

    return evaluate


def degree(expr: Expr, symbols: Iterable[Symbol]) -> Optional[int]:
    """The total degree of ``expr`` as a polynomial in ``symbols``, with
    every other symbol treated as a coefficient; None if ``expr`` is not
    polynomial in them (e.g. a symbol under a function or in a
    denominator). Terms are not collected, so ``y * y - y * y`` counts
    as degree 2."""
    symbols = frozenset(symbols)
    memo: Dict[int, Optional[int]] = {}

    def visit(node: Expr) -> Optional[int]:
        key = id(node)
        if key in memo:
            return memo[key]
        op = node.op
        if op == "symbol":
            result = 1 if node in symbols else 0
        elif op == "const":
            result = 0
        elif op == "neg":
            result = visit(node.args[0])
        elif op in ("add", "sub", "mul", "div", "pow"):
            a, b = visit(node.args[0]), visit(node.args[1])
            if a is None or b is None:
                result = None
            elif op in ("add", "sub"):
                result = max(a, b)
            elif op == "mul":
                result = a + b
            elif op == "div":
                result = a if b == 0 else None
            elif a == 0 and b == 0:
                result = 0
            else:
                exponent = node.args[1]
                is_natural = (
                    exponent.op == "const"
                    and float(exponent.args[0]).is_integer()
                    and exponent.args[0] >= 0
                )
                result = (
                    a * int(exponent.args[0])
                    if b == 0 and is_natural
                    else None
                )
        else:
            result = 0 if visit(node.args[0]) == 0 else None
        memo[key] = result
        return result

    return visit(as_expr(expr))
