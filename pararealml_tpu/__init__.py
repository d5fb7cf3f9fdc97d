"""pararealml_tpu: a JAX differential-equation solving framework.

A ground-up JAX/XLA re-design with the capabilities of the
reference *PararealML* library: a unified ``Operator.solve(ivp)``
interface, interchangeable solvers (FDM, adaptive ODE, supervised ML,
physics-informed ML), and a Parareal parallel-in-time framework that runs
as a single compiled XLA program over a device mesh instead of MPI
ranks.

The public API surface mirrors the reference package root
(/root/reference/pararealml/__init__.py:68-124).
"""

from pararealml_tpu.boundary_condition import (
    BoundaryCondition,
    CauchyBoundaryCondition,
    ConstantBoundaryCondition,
    ConstantFluxBoundaryCondition,
    ConstantValueBoundaryCondition,
    DirichletBoundaryCondition,
    NeumannBoundaryCondition,
    VectorizedBoundaryConditionFunction,
    vectorize_bc_function,
)
from pararealml_tpu.constrained_problem import (
    BoundaryConstraintPair,
    BoundaryConstraints,
    ConstrainedProblem,
)
from pararealml_tpu.constraint import (
    Constraint,
    apply_constraints_along_last_axis,
)
from pararealml_tpu.differential_equation import (
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
from pararealml_tpu.initial_condition import (
    ConstantInitialCondition,
    ContinuousInitialCondition,
    DiscreteInitialCondition,
    GaussianInitialCondition,
    InitialCondition,
    MarginalBetaProductInitialCondition,
    VectorizedInitialConditionFunction,
    vectorize_ic_function,
)
from pararealml_tpu.initial_value_problem import InitialValueProblem
from pararealml_tpu.mesh import (
    CoordinateSystem,
    Mesh,
    from_cartesian_coordinates,
    to_cartesian_coordinates,
    unit_vectors_at,
)
from pararealml_tpu.plot import (
    AnimatedPlot,
    ContourPlot,
    NBodyPlot,
    PhaseSpacePlot,
    Plot,
    QuiverPlot,
    ScatterPlot,
    SpaceLinePlot,
    StreamPlot,
    SurfacePlot,
    TimePlot,
)
from pararealml_tpu.solution import Diffs, Solution

__version__ = "0.1.0"

__all__ = [
    "BoundaryCondition",
    "DirichletBoundaryCondition",
    "NeumannBoundaryCondition",
    "CauchyBoundaryCondition",
    "ConstantBoundaryCondition",
    "ConstantValueBoundaryCondition",
    "ConstantFluxBoundaryCondition",
    "VectorizedBoundaryConditionFunction",
    "vectorize_bc_function",
    "ConstrainedProblem",
    "BoundaryConstraintPair",
    "BoundaryConstraints",
    "apply_constraints_along_last_axis",
    "Constraint",
    "Symbols",
    "LHS",
    "SymbolicEquationSystem",
    "DifferentialEquation",
    "PopulationGrowthEquation",
    "LotkaVolterraEquation",
    "LorenzEquation",
    "SIREquation",
    "VanDerPolEquation",
    "NBodyGravitationalEquation",
    "DiffusionEquation",
    "ConvectionDiffusionEquation",
    "WaveEquation",
    "CahnHilliardEquation",
    "BurgersEquation",
    "ShallowWaterEquation",
    "NavierStokesEquation",
    "InitialCondition",
    "DiscreteInitialCondition",
    "ConstantInitialCondition",
    "ContinuousInitialCondition",
    "GaussianInitialCondition",
    "MarginalBetaProductInitialCondition",
    "VectorizedInitialConditionFunction",
    "vectorize_ic_function",
    "InitialValueProblem",
    "CoordinateSystem",
    "Mesh",
    "to_cartesian_coordinates",
    "from_cartesian_coordinates",
    "unit_vectors_at",
    "Plot",
    "AnimatedPlot",
    "TimePlot",
    "PhaseSpacePlot",
    "NBodyPlot",
    "SpaceLinePlot",
    "ContourPlot",
    "SurfacePlot",
    "ScatterPlot",
    "StreamPlot",
    "QuiverPlot",
    "Diffs",
    "Solution",
]
