"""Parareal over vmap-batched small-grid slices: 16 slices on at most 8
devices, so each device vmaps two fine solves. Every relaxation and
materialization schedule is compared with the sequential fine solve,
for a linear scalar problem and three systems (one with an algebraic
equation)."""

import numpy as np
import pytest

from pararealml_tpu import DiscreteInitialCondition, InitialValueProblem
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    RK4,
    ThreePointCentralDifferenceMethod,
)
from pararealml_tpu.operators.parareal import PararealOperator
from tests.operators.fdm import generic_family_cases as cases

N_SLICES = 16
FAMILIES = {
    "diffusion": (cases.diffusion_flux_neumann, 0.01, 0.04),
    "wave": (cases.wave_neumann, 0.005, 0.02),
    "burgers": (cases.burgers_neumann, 0.005, 0.02),
    "cahn_hilliard": (cases.cahn_hilliard_neumann, 2e-5, 8e-5),
}


@pytest.mark.parametrize("materialize", ["final", "iteration"])
@pytest.mark.parametrize("relaxation", ["f", "fcf"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_parareal_matches_fine(family, relaxation, materialize):
    builder, fine_d_t, coarse_d_t = FAMILIES[family]
    cp, y_0, _, _ = builder()
    ic = DiscreteInitialCondition(cp, y_0, vertex_oriented=True)
    t_end = N_SLICES * 2 * coarse_d_t
    ivp = InitialValueProblem(cp, (0.0, t_end), ic)
    fine = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), fine_d_t
    )
    coarse = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), coarse_d_t
    )
    parareal = PararealOperator(
        fine,
        coarse,
        1e-7,
        num_time_slices=N_SLICES,
        relaxation=relaxation,
        materialize=materialize,
    )
    y = parareal.solve(ivp).discrete_y()
    fine_y = fine.solve(ivp).discrete_y()
    assert y.shape == fine_y.shape
    scale = max(1.0, float(np.abs(fine_y).max()))
    # converged to a 1e-7 border-update RMS; the stored trajectories
    # differ from the fine solve by at most a few such updates
    assert np.max(np.abs(y - fine_y)) < 1e-5 * scale
