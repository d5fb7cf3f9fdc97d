"""Shared problem builders for the differential-parity harness.

Each case builds the SAME initial value problem through either
implementation's public namespace (``vars(pararealml)`` for the
reference, ``vars(pararealml_tpu)`` for this package), so the live
parity tests (tests/test_reference_parity.py) and the vendored-fixture
generator/tests (tests/fixtures/, tests/test_vendored_parity.py) agree
on exactly what is being compared.

Every one of the 13 built-in equation families appears once, with a
small enough discretization that a full trajectory fixture stays a few
kilobytes.
"""

from typing import Any, Dict

import numpy as np


def _neumann_pair(module, n_components):
    return (
        module["NeumannBoundaryCondition"](
            lambda x, t: np.zeros((len(x), n_components)),
            is_static=True,
        ),
    ) * 2


def _ode_case(equation_factory, y_0_values, d_t, steps):
    def build(module):
        diff_eq = equation_factory(module)
        cp = module["ConstrainedProblem"](diff_eq)
        ic = module["ContinuousInitialCondition"](
            cp, lambda _: np.array(y_0_values, dtype=float)
        )
        return module["InitialValueProblem"](
            cp, (0.0, steps * d_t), ic
        )

    return {"build": build, "d_t": d_t}


def _pde_case(
    equation_factory,
    intervals,
    d_x,
    n_components,
    means,
    d_t,
    steps,
    multipliers=None,
    dirichlet_axes=(),
):
    def build(module):
        diff_eq = equation_factory(module)
        mesh = module["Mesh"](intervals, d_x)
        bcs = []
        for axis in range(len(intervals)):
            if axis in dirichlet_axes:
                bcs.append(
                    (
                        module["DirichletBoundaryCondition"](
                            lambda x, t: np.full(
                                (len(x), n_components), 1.0
                            ),
                            is_static=True,
                        ),
                    )
                    * 2
                )
            else:
                bcs.append(_neumann_pair(module, n_components))
        cp = module["ConstrainedProblem"](diff_eq, mesh, bcs)
        x_dim = len(intervals)
        centers = [
            (lo + hi) / 2.0 for lo, hi in intervals
        ]
        ic = module["GaussianInitialCondition"](
            cp,
            [
                (np.array(centers), np.eye(x_dim) * 0.1)
                for _ in range(n_components)
            ],
            multipliers
            if multipliers is not None
            else list(means),
        )
        return module["InitialValueProblem"](
            cp, (0.0, steps * d_t), ic
        )

    return {"build": build, "d_t": d_t}


def _navier_stokes_ivp(module):
    """A shrunken version of the reference's own lid-driven
    configuration (/root/reference/examples/navier_stokes_fdm.py):
    Dirichlet vorticity/stream-function boundaries keep the
    stream-function anti-Laplacian solve non-singular (all-Neumann
    boundaries leave the Jacobi iteration on a null-space and it never
    converges)."""
    diff_eq = module["NavierStokesEquation"](5000.0)
    mesh = module["Mesh"]([(0.0, 1.0), (0.0, 1.0)], [0.125, 0.125])
    vectorize = module["vectorize_bc_function"]

    def lid(x, t):
        return [1.0, 0.1, None, None]

    def wall(x, t):
        return [0.0, 0.0, None, None]

    bcs = [
        (
            module["DirichletBoundaryCondition"](
                vectorize(lid), is_static=True
            ),
            module["DirichletBoundaryCondition"](
                vectorize(wall), is_static=True
            ),
        ),
        (
            module["DirichletBoundaryCondition"](
                vectorize(wall), is_static=True
            ),
            module["DirichletBoundaryCondition"](
                vectorize(wall), is_static=True
            ),
        ),
    ]
    cp = module["ConstrainedProblem"](diff_eq, mesh, bcs)
    ic = module["ContinuousInitialCondition"](
        cp, lambda x: np.zeros((len(x), 4))
    )
    return module["InitialValueProblem"](cp, (0.0, 0.25), ic)


def equation_cases() -> Dict[str, Dict[str, Any]]:
    """One FDM-solvable case per built-in equation family."""
    return {
        "population_growth": _ode_case(
            lambda m: m["PopulationGrowthEquation"](0.5),
            [100.0],
            0.05,
            8,
        ),
        "lotka_volterra": _ode_case(
            lambda m: m["LotkaVolterraEquation"](2.0, 0.04, 1.06, 0.02),
            [100.0, 15.0],
            0.02,
            8,
        ),
        "lorenz": _ode_case(
            lambda m: m["LorenzEquation"](10.0, 28.0, 8.0 / 3.0),
            [1.0, 1.0, 1.0],
            0.005,
            8,
        ),
        "sir": _ode_case(
            lambda m: m["SIREquation"](0.3, 0.1),
            [999.0, 1.0, 0.0],
            0.05,
            8,
        ),
        "van_der_pol": _ode_case(
            lambda m: m["VanDerPolEquation"](1.5),
            [1.0, 0.0],
            0.02,
            8,
        ),
        "n_body": _ode_case(
            lambda m: m["NBodyGravitationalEquation"](
                2, [5e10, 5e10], 6.6743e-11
            ),
            [0.0, 0.0, 0.0, 0.5, 10.0, 0.0, 0.0, -0.5],
            0.01,
            8,
        ),
        "diffusion": _pde_case(
            lambda m: m["DiffusionEquation"](1, 0.4),
            [(0.0, 1.0)],
            [0.1],
            1,
            [5.0],
            0.002,
            6,
            dirichlet_axes=(0,),
        ),
        "convection_diffusion": _pde_case(
            lambda m: m["ConvectionDiffusionEquation"](
                2, [0.4, -0.2], 0.3
            ),
            [(0.0, 1.0), (0.0, 1.0)],
            [0.125, 0.125],
            1,
            [4.0],
            0.002,
            6,
        ),
        "wave": _pde_case(
            lambda m: m["WaveEquation"](2, 1.5),
            [(0.0, 1.0), (0.0, 1.0)],
            [0.125, 0.125],
            2,
            [1.0, 0.0],
            0.002,
            6,
            dirichlet_axes=(0,),
        ),
        "cahn_hilliard": _pde_case(
            lambda m: m["CahnHilliardEquation"](1, 0.5, 0.02),
            [(0.0, 1.0)],
            [0.05],
            2,
            [0.5, 0.0],
            0.0005,
            6,
        ),
        "burgers": _pde_case(
            lambda m: m["BurgersEquation"](2, 100.0),
            [(0.0, 1.0), (0.0, 1.0)],
            [0.125, 0.125],
            2,
            [0.5, 0.1],
            0.002,
            6,
        ),
        "shallow_water": _pde_case(
            lambda m: m["ShallowWaterEquation"](0.5),
            [(0.0, 1.0), (0.0, 1.0)],
            [0.125, 0.125],
            3,
            [1.0, 0.0, 0.0],
            0.001,
            6,
        ),
        "navier_stokes": {
            "build": _navier_stokes_ivp,
            "d_t": 0.05,
            # drive the stream-function Jacobi solve to a tight fixed
            # point on both sides so the trajectories are comparable
            # beyond the solver tolerance
            "differentiator_tol": 1e-10,
        },
    }


def solve_fdm_trajectory(module_namespace, fdm_namespace, case):
    """Solves a case with the namespace's FDM operator (RK4 + three-point
    central differences) and returns the discrete trajectory as
    float64."""
    ivp = case["build"](module_namespace)
    differentiator = fdm_namespace["ThreePointCentralDifferenceMethod"](
        case.get("differentiator_tol", 1e-3)
    )
    operator = fdm_namespace["FDMOperator"](
        fdm_namespace["RK4"](), differentiator, case["d_t"]
    )
    solution = operator.solve(ivp)
    return np.asarray(solution.discrete_y(), np.float64)
