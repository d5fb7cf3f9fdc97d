# Reproduces the corresponding reference example's problem
# configuration (/root/reference/examples/) so results and
# tolerances are directly comparable.
import _common  # noqa: F401
import numpy as np

from pararealml_tpu import *
from pararealml_tpu.operators.fdm import *
from pararealml_tpu.operators.parareal import *
from pararealml_tpu.utils.time import device_time

diff_eq = DiffusionEquation(2)
mesh = Mesh([(0.0, 10.0), (0.0, 10.0)], [0.5, 0.5])
bcs = [
    (
        DirichletBoundaryCondition(
            lambda x, t: np.full((len(x), 1), 1.5), is_static=True
        ),
        DirichletBoundaryCondition(
            lambda x, t: np.full((len(x), 1), 1.5), is_static=True
        ),
    ),
    (
        NeumannBoundaryCondition(
            lambda x, t: np.zeros((len(x), 1)), is_static=True
        ),
        NeumannBoundaryCondition(
            lambda x, t: np.zeros((len(x), 1)), is_static=True
        ),
    ),
]
cp = ConstrainedProblem(diff_eq, mesh, bcs)
ic = GaussianInitialCondition(
    cp, [(np.array([5.0, 5.0]), np.eye(2))], [1000.0]
)
ivp = InitialValueProblem(cp, (0.0, 40.0), ic)

f = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.001)
g = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.01)
p = PararealOperator(f, g, 0.0025, num_time_slices=8)

device_time("fine")(f.solve)(ivp)
device_time("coarse")(g.solve)(ivp)
device_time("parareal")(p.solve)(ivp)
