# Spatial domain decomposition — a capability beyond the reference
# (whose parallelism is time-only MPI): the grid, every stencil
# evaluation, and the stored trajectory shard over all visible devices,
# with the halo exchanges inserted by XLA's SPMD partitioner. Run with
# XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu
# to try an 8-way decomposition without several accelerators.
import _common  # noqa: F401
import numpy as np

from pararealml_tpu import *
from pararealml_tpu.operators.fdm import *
from pararealml_tpu.utils.distributed import space_mesh
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
ivp = InitialValueProblem(cp, (0.0, 2.0), ic)

single = FDMOperator(
    RK4(), ThreePointCentralDifferenceMethod(), 0.002
)
sharded = FDMOperator(
    RK4(),
    ThreePointCentralDifferenceMethod(),
    0.002,
    spatial_mesh=space_mesh(),
)

single_solution, _ = device_time("single-device")(single.solve)(ivp)
sharded_solution, _ = device_time("space-sharded")(sharded.solve)(ivp)

max_diff = np.max(
    np.abs(
        sharded_solution.discrete_y() - single_solution.discrete_y()
    )
)
print(f"max diff, decomposed vs single-device: {max_diff:.3e}")

for i, plot in enumerate(sharded_solution.generate_plots(n_frames=20)):
    plot.save(f"diffusion_2d_space_sharded_{i}").close()
