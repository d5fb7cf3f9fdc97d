"""Tests of the expression language equations are written in: every
built-in right-hand side against a hand-written NumPy version, the
arithmetic and function rules, ``free_symbols``, and the degree query
the affine-propagator check relies on."""

import numpy as np
import pytest

from pararealml_tpu import (
    BurgersEquation,
    CahnHilliardEquation,
    ConstrainedProblem,
    ContinuousInitialCondition,
    ConvectionDiffusionEquation,
    DifferentialEquation,
    DiffusionEquation,
    InitialValueProblem,
    LorenzEquation,
    LotkaVolterraEquation,
    NavierStokesEquation,
    NBodyGravitationalEquation,
    PopulationGrowthEquation,
    ShallowWaterEquation,
    SIREquation,
    SymbolicEquationSystem,
    VanDerPolEquation,
    WaveEquation,
)
from pararealml_tpu import expression as ex
from pararealml_tpu.expression import (
    Expr,
    Symbol,
    compile_expressions,
    degree,
    symarray,
)


def _nbody_rhs(v):
    g, m = 1.0, (2.0, 3.0)
    p0 = np.array([v["y_0"], v["y_1"]])
    p1 = np.array([v["y_2"], v["y_3"]])
    d = p1 - p0
    force = g * m[0] * m[1] / np.linalg.norm(d) ** 3 * d
    return [v["y_4"], v["y_5"], v["y_6"], v["y_7"], *(force / m[0]),
            *(-force / m[1])]


def _shallow_water_rhs(v):
    h, b, visc, f, g = 0.5, 0.01, 0.1, 0.02, 9.80665
    eta, u, w = v["y_0"], v["y_1"], v["y_2"]

    def grad(i, j):
        return v[f"y-gradient_{i}_{j}"]

    return [
        -h * v["y-divergence_1_2"] - eta * grad(1, 0) - u * grad(0, 0)
        - eta * grad(2, 1) - w * grad(0, 1),
        visc * v["y-laplacian_1"] - u * grad(1, 0) - w * grad(1, 1)
        - g * grad(0, 0) - b * u + f * w,
        visc * v["y-laplacian_2"] - u * grad(2, 0) - w * grad(2, 1)
        - g * grad(0, 1) - b * w - f * u,
    ]


BUILTINS = {
    "population_growth": (
        lambda: PopulationGrowthEquation(0.01),
        lambda v: [0.01 * v["y_0"]],
    ),
    "lotka_volterra": (
        lambda: LotkaVolterraEquation(2.0, 0.04, 1.06, 0.02),
        lambda v: [
            2.0 * v["y_0"] - 0.04 * v["y_0"] * v["y_1"],
            0.02 * v["y_0"] * v["y_1"] - 1.06 * v["y_1"],
        ],
    ),
    "lorenz": (
        lambda: LorenzEquation(10.0, 28.0, 8.0 / 3.0),
        lambda v: [
            10.0 * (v["y_1"] - v["y_0"]),
            v["y_0"] * (28.0 - v["y_2"]) - v["y_1"],
            v["y_0"] * v["y_1"] - 8.0 / 3.0 * v["y_2"],
        ],
    ),
    "sir": (
        lambda: SIREquation(0.2, 0.1),
        lambda v: (
            lambda inf: [-inf, inf - 0.1 * v["y_1"], 0.1 * v["y_1"]]
        )(0.2 * v["y_0"] * v["y_1"] / (v["y_0"] + v["y_1"] + v["y_2"])),
    ),
    "van_der_pol": (
        lambda: VanDerPolEquation(1.5),
        lambda v: [
            v["y_1"],
            1.5 * (1.0 - v["y_0"] ** 2) * v["y_1"] - v["y_0"],
        ],
    ),
    "n_body": (
        lambda: NBodyGravitationalEquation(2, [2.0, 3.0], 1.0),
        _nbody_rhs,
    ),
    "diffusion": (
        lambda: DiffusionEquation(2, 1.5),
        lambda v: [1.5 * v["y-laplacian_0"]],
    ),
    "convection_diffusion": (
        lambda: ConvectionDiffusionEquation(2, [0.4, -0.2], 0.3),
        lambda v: [
            0.3 * v["y-laplacian_0"]
            - (0.4 * v["y-gradient_0_0"] - 0.2 * v["y-gradient_0_1"])
        ],
    ),
    "wave": (
        lambda: WaveEquation(2, 1.5),
        lambda v: [v["y_1"], 2.25 * v["y-laplacian_0"]],
    ),
    "cahn_hilliard": (
        lambda: CahnHilliardEquation(2, 0.1, 0.01),
        lambda v: [
            0.1 * v["y-laplacian_1"],
            v["y_0"] ** 3 - v["y_0"] - 0.01 * v["y-laplacian_0"],
        ],
    ),
    "burgers": (
        lambda: BurgersEquation(2, 100.0),
        lambda v: [
            0.01 * v[f"y-laplacian_{i}"]
            - v["y_0"] * v[f"y-gradient_{i}_0"]
            - v["y_1"] * v[f"y-gradient_{i}_1"]
            for i in range(2)
        ],
    ),
    "shallow_water": (
        lambda: ShallowWaterEquation(0.5, 0.01, 0.1, 0.02),
        _shallow_water_rhs,
    ),
    "navier_stokes": (
        lambda: NavierStokesEquation(4000.0),
        lambda v: [
            v["y-laplacian_0"] / 4000.0
            - v["y_2"] * v["y-gradient_0_0"]
            - v["y_3"] * v["y-gradient_0_1"],
            -v["y_0"],
            v["y-gradient_1_1"],
            -v["y-gradient_1_0"],
        ],
    ),
}


@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_builtin_rhs_matches_numpy(name):
    make_equation, numpy_rhs = BUILTINS[name]
    rhs = make_equation().symbolic_equation_system.rhs
    symbols = sorted(
        set().union(*[e.free_symbols for e in rhs]), key=lambda s: s.name
    )
    rng = np.random.default_rng(len(name))
    values = {s.name: float(rng.uniform(0.5, 1.5)) for s in symbols}
    evaluate = compile_expressions(rhs, symbols)
    actual = [float(v) for v in evaluate([values[s.name] for s in symbols])]
    np.testing.assert_allclose(actual, numpy_rhs(values), rtol=1e-12)


A, B = Symbol("a"), Symbol("b")
A_VALUE, B_VALUE = 1.7, 0.6

ARITHMETIC = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a**b,
    "integer_pow": lambda a, b: a**3,
    "neg": lambda a, b: -a,
    "radd": lambda a, b: 2.0 + a,
    "rsub": lambda a, b: 2.0 - b,
    "rmul": lambda a, b: 3 * b,
    "rdiv": lambda a, b: 2.0 / a,
    "rpow": lambda a, b: 2.0**b,
    "nested": lambda a, b: (a + 1) * (b - 2) / a**2 - -b,
}


@pytest.mark.parametrize("op", sorted(ARITHMETIC))
def test_arithmetic_matches_python(op):
    rule = ARITHMETIC[op]
    (value,) = compile_expressions([rule(A, B)], [A, B])([A_VALUE, B_VALUE])
    assert float(value) == pytest.approx(rule(A_VALUE, B_VALUE), rel=1e-12)


FUNCTIONS = {
    "sqrt": np.sqrt,
    "exp": np.exp,
    "log": np.log,
    "sin": np.sin,
    "cos": np.cos,
    "tanh": np.tanh,
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functions_match_numpy(name):
    expr = getattr(ex, name)(2.0 * A)
    assert expr.free_symbols == {A}
    (value,) = compile_expressions([expr], [A])([A_VALUE])
    assert float(value) == pytest.approx(
        FUNCTIONS[name](2.0 * A_VALUE), rel=1e-12
    )


def test_free_symbols_and_symbol_identity():
    expr = ex.sin(A) * 2.0 + A / B - 3.0
    assert expr.free_symbols == {A, B}
    assert Symbol("a") == A and hash(Symbol("a")) == hash(A)
    assert Symbol("a") != B
    assert (A + B) == (Symbol("a") + Symbol("b"))
    assert (A + B) != (B + A)
    assert ex.as_expr(2.0).free_symbols == frozenset()


def test_symarray_names_follow_the_grammar():
    array = symarray("y-gradient", (2, 3))
    assert array.shape == (2, 3)
    assert array[1, 2].name == "y-gradient_1_2"
    assert all(isinstance(s, Symbol) for s in array.flat)


DEGREES = {
    "symbol": (lambda y, x: y, 1),
    "affine": (lambda y, x: 3.0 * y + x - 1.0, 1),
    "product": (lambda y, x: y * y, 2),
    "coefficient": (lambda y, x: y * x + 1.0, 1),
    "divided_by_coefficient": (lambda y, x: y / x, 1),
    "in_denominator": (lambda y, x: x / y, None),
    "under_function": (lambda y, x: ex.sin(y), None),
    "function_coefficient": (lambda y, x: ex.sin(x) * y, 1),
    "square": (lambda y, x: (y + x) ** 2, 2),
    "root": (lambda y, x: y**0.5, None),
    "negated": (lambda y, x: -(y + 2.0), 1),
    "constant": (lambda y, x: x * 2.0, 0),
}


@pytest.mark.parametrize("name", sorted(DEGREES))
def test_degree_query(name):
    build, expected = DEGREES[name]
    y, x = Symbol("y_0"), Symbol("x_0")
    assert degree(build(y, x), {y}) == expected


def test_foreign_objects_are_rejected():
    with pytest.raises(TypeError):
        A + object()
    with pytest.raises(TypeError, match="not supported"):
        SymbolicEquationSystem(["y_0 + 1"])
    with pytest.raises(TypeError, match="not supported"):
        ex.as_expr(True)


def test_constant_right_hand_side():
    eq_sys = SymbolicEquationSystem([2.5])
    assert isinstance(eq_sys.rhs[0], Expr)
    assert compile_expressions(eq_sys.rhs, [])([]) == [2.5]
    with pytest.raises(ValueError, match="no value"):
        compile_expressions([A + B], [A])


def test_user_equation_with_functions_solves():
    from pararealml_tpu.operators.ode import ODEOperator

    class Forced(DifferentialEquation):
        def __init__(self):
            super().__init__(0, 1)

        @property
        def symbolic_equation_system(self):
            t = self._symbols.t
            return SymbolicEquationSystem([ex.cos(t) * ex.exp(0.0 * t)])

    cp = ConstrainedProblem(Forced())
    ic = ContinuousInitialCondition(cp, lambda _: np.array([1.0]))
    ivp = InitialValueProblem(cp, (0.0, 2.0), ic)
    solution = ODEOperator("RK45", 0.1, rtol=1e-10, atol=1e-12).solve(ivp)
    np.testing.assert_allclose(
        solution.discrete_y()[:, 0],
        1.0 + np.sin(solution.t_coordinates),
        atol=1e-8,
    )
