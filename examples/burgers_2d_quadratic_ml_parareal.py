# Parareal with a trained NONLINEAR ML coarse operator on a NONLINEAR
# problem (2D viscous Burgers) — the composition the reference exists
# to study (/root/reference/README.md:9), on a problem whose slice
# jump is not affine so a linear surrogate cannot represent it. The
# coarse operator is a ReducedQuadraticStateOperatorRegressor: a
# closed-form ridge fit of a full-rank linear term plus a quadratic
# term in a POD-reduced subspace of the training states, applied as
# two dense matmuls per slice jump inside the compiled Parareal
# program.
import _common  # noqa: F401
import numpy as np

from pararealml_tpu import *
from pararealml_tpu.operators.fdm import *
from pararealml_tpu.operators.ml.supervised import (
    ReducedQuadraticStateOperatorRegressor,
    SupervisedMLOperator,
)
from pararealml_tpu.operators.parareal import PararealOperator
from pararealml_tpu.utils.rand import SEEDS, set_random_seed
from pararealml_tpu.utils.time import device_time

set_random_seed(SEEDS[0])

diff_eq = BurgersEquation(2, 100.0)
mesh = Mesh([(0.0, 5.0)] * 2, [0.25] * 2)
bcs = [
    (
        NeumannBoundaryCondition(
            lambda x, t: np.zeros((len(x), 2)), is_static=True
        ),
    )
    * 2
] * 2
cp = ConstrainedProblem(diff_eq, mesh, bcs)
ic = GaussianInitialCondition(
    cp, [(np.full(2, 2.5), 0.75 * np.eye(2))] * 2, [1.0, 0.5]
)
t_end = 40.0
ivp = InitialValueProblem(cp, (0.0, t_end), ic)

n_slices = 20
fine = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.0025)

# train the quadratic slice-jump surrogate on fine trajectories of
# perturbed initial conditions (the reference's training recipe,
# /root/reference/pararealml/operators/ml/supervised/
# supervised_ml_operator.py:130-236)
coarse_sml = SupervisedMLOperator(t_end / n_slices, True)
data = coarse_sml.generate_data(
    ivp,
    fine,
    10,
    lambda t, y: y * np.random.uniform(0.9, 1.1, size=y.shape),
)
n_y = int(np.prod(cp.y_shape(True)))
model = ReducedQuadraticStateOperatorRegressor(n_y, rank=24)
train_mse, test_mse = coarse_sml.fit_model(model, data)
print("coarse surrogate train MSE:", train_mse, "test:", test_mse)
coarse_sml.model = model

parareal = PararealOperator(
    fine, coarse_sml, 0.0025, num_time_slices=n_slices
)

fine_solution, fine_seconds = device_time("fine")(fine.solve)(ivp)
parareal_solution, parareal_seconds = device_time("parareal+quad-ml")(
    parareal.solve
)(ivp)

diff = fine_solution.diff([parareal_solution])
print("max abs diff vs fine:", np.max(np.abs(diff.differences[0])))
print(
    f"speedup vs sequential fine: {fine_seconds / parareal_seconds:.2f}x"
)

for i, plot in enumerate(parareal_solution.generate_plots()):
    plot.save(f"burgers_2d_quadratic_ml_parareal_{i}").close()
