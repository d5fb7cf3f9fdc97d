import numpy as np
import pytest

from pararealml_tpu import (
    LHS,
    BurgersEquation,
    CahnHilliardEquation,
    ConvectionDiffusionEquation,
    DifferentialEquation,
    DiffusionEquation,
    LorenzEquation,
    LotkaVolterraEquation,
    NavierStokesEquation,
    NBodyGravitationalEquation,
    PopulationGrowthEquation,
    ShallowWaterEquation,
    SIREquation,
    SymbolicEquationSystem,
    Symbols,
    VanDerPolEquation,
    WaveEquation,
)
from pararealml_tpu.expression import compile_expressions


def test_symbols_ode():
    symbols = Symbols(0, 3)
    assert symbols.x is None
    assert symbols.y_gradient is None
    assert symbols.y_laplacian is None
    assert len(symbols.y) == 3
    assert symbols.t.name == "t"


def test_symbols_pde():
    symbols = Symbols(2, 3)
    assert symbols.x.shape == (2,)
    assert symbols.y_gradient.shape == (3, 2)
    assert symbols.y_hessian.shape == (3, 2, 2)
    assert symbols.y_divergence.shape == (3, 3)
    assert symbols.y_laplacian.shape == (3,)
    assert symbols.y_vector_laplacian.shape == (3, 3, 2)
    assert symbols.y_gradient[1, 0].name == "y-gradient_1_0"


def test_symbolic_equation_system_validation():
    symbols = Symbols(0, 2)
    with pytest.raises(ValueError):
        SymbolicEquationSystem([])
    with pytest.raises(ValueError):
        SymbolicEquationSystem([symbols.y[0]], [LHS.D_Y_OVER_D_T] * 2)


def test_symbolic_equation_system_indices_by_type():
    eq_sys = CahnHilliardEquation(2).symbolic_equation_system
    assert eq_sys.equation_indices_by_type(LHS.D_Y_OVER_D_T) == [0]
    assert eq_sys.equation_indices_by_type(LHS.Y) == [1]
    assert eq_sys.equation_indices_by_type(LHS.Y_LAPLACIAN) == []


def test_differential_equation_validation():
    with pytest.raises(ValueError):
        DiffusionEquation(0)
    with pytest.raises(ValueError):
        ConvectionDiffusionEquation(2, [1.0])
    with pytest.raises(ValueError):
        LotkaVolterraEquation(alpha=-1.0)
    with pytest.raises(ValueError):
        NBodyGravitationalEquation(4, [1.0, 1.0])
    with pytest.raises(ValueError):
        NBodyGravitationalEquation(2, [1.0])
    with pytest.raises(ValueError):
        NBodyGravitationalEquation(2, [1.0, -1.0])


def test_ode_lhs_must_be_d_y_over_d_t():
    class BadODE(DifferentialEquation):
        def __init__(self):
            super().__init__(0, 1)

        @property
        def symbolic_equation_system(self):
            return SymbolicEquationSystem([self._symbols.y[0]], [LHS.Y])

    with pytest.raises(ValueError):
        BadODE()


def test_all_builtin_equations_construct():
    equations = [
        PopulationGrowthEquation(),
        LotkaVolterraEquation(),
        LorenzEquation(),
        SIREquation(),
        VanDerPolEquation(),
        NBodyGravitationalEquation(3, [1.0, 2.0, 3.0]),
        DiffusionEquation(2),
        ConvectionDiffusionEquation(2, [1.0, -1.0]),
        WaveEquation(2),
        CahnHilliardEquation(2),
        BurgersEquation(2),
        ShallowWaterEquation(2.0),
        NavierStokesEquation(),
    ]
    for eq in equations:
        assert len(eq.symbolic_equation_system.rhs) == eq.y_dimension


def test_n_body_structure():
    diff_eq = NBodyGravitationalEquation(2, [2.0, 3.0])
    assert diff_eq.n_objects == 2
    assert diff_eq.spatial_dimension == 2
    assert diff_eq.y_dimension == 8
    rhs = diff_eq.symbolic_equation_system.rhs
    # position derivatives are the velocity symbols
    assert rhs[0].name == "y_4"
    # forces are opposite and scaled by masses: the total momentum
    # change vanishes at any configuration
    symbols = list(diff_eq.symbols.y)
    momentum_change = compile_expressions(
        [2.0 * rhs[4] + 3.0 * rhs[6], 2.0 * rhs[5] + 3.0 * rhs[7]],
        symbols,
    )
    values = np.random.default_rng(0).standard_normal(len(symbols))
    np.testing.assert_allclose(
        np.asarray(momentum_change(list(values)), float), 0.0, atol=1e-24
    )


def test_navier_stokes_lhs_types():
    eq_sys = NavierStokesEquation().symbolic_equation_system
    assert eq_sys.lhs_types == [
        LHS.D_Y_OVER_D_T,
        LHS.Y_LAPLACIAN,
        LHS.Y,
        LHS.Y,
    ]


def test_vector_field_indices():
    assert BurgersEquation(2).all_vector_field_indices == [(0, 1)]
    assert ShallowWaterEquation(2.0).all_vector_field_indices == [(1, 2)]
    assert NavierStokesEquation().all_vector_field_indices == [(2, 3)]
    assert np.all(
        DiffusionEquation(1).all_vector_field_indices is None
    )
