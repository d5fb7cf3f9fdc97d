# Space x time Parareal — a composition beyond the reference (whose
# parallelism is time-only MPI): time slices shard over the mesh's
# `time` axis while every fine/coarse stencil evaluation decomposes
# over its `space` axis, all one compiled GSPMD program. Run with
# XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
# to try a 2x4 (time x space) mesh without several accelerators.
import _common  # noqa: F401
import jax
import numpy as np
from jax.sharding import Mesh as DeviceMesh

from pararealml_tpu import *
from pararealml_tpu.operators.fdm import *
from pararealml_tpu.operators.parareal import SpaceTimePararealOperator
from pararealml_tpu.utils.time import device_time

diff_eq = DiffusionEquation(2)
mesh = Mesh([(0.0, 10.0), (0.0, 10.0)], [0.25, 0.25])
bcs = [
    (
        DirichletBoundaryCondition(
            lambda x, t: np.full((len(x), 1), 1.5), is_static=True
        ),
    )
    * 2,
    (
        NeumannBoundaryCondition(
            lambda x, t: np.zeros((len(x), 1)), is_static=True
        ),
    )
    * 2,
]
cp = ConstrainedProblem(diff_eq, mesh, bcs)
ic = GaussianInitialCondition(
    cp, [(np.array([5.0, 5.0]), np.eye(2))], [1000.0]
)
ivp = InitialValueProblem(cp, (0.0, 4.0), ic)

f = FDMOperator(
    RK4(), ThreePointCentralDifferenceMethod(), 0.002
)
g = FDMOperator(
    RK4(), ThreePointCentralDifferenceMethod(), 0.01
)

devices = np.array(jax.devices())
time_size = 2 if len(devices) % 2 == 0 and len(devices) > 1 else 1
device_mesh = DeviceMesh(
    devices.reshape(time_size, len(devices) // time_size),
    ("time", "space"),
)
print(f"device mesh: {dict(device_mesh.shape)}")

parareal = SpaceTimePararealOperator(
    f, g, 0.0025, num_time_slices=2 * time_size, mesh=device_mesh
)

fine_solution, _ = device_time("fine (single device)")(f.solve)(ivp)
parareal_solution, _ = device_time("space-time parareal")(
    parareal.solve
)(ivp)

max_diff = np.max(
    np.abs(
        parareal_solution.discrete_y() - fine_solution.discrete_y()
    )
)
print(f"max diff, space-time parareal vs fine: {max_diff:.3e}")

for i, plot in enumerate(
    parareal_solution.generate_plots(n_frames=20)
):
    plot.save(f"diffusion_2d_space_time_parareal_{i}").close()
