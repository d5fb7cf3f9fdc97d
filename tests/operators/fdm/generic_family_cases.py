"""Small FDM problems for every equation family, boundary condition and
geometry the generic solver path serves, plus the checks the float32
generic-path tests share.

Each builder returns ``(cp, y_0, d_t, steps)`` and builds a fresh
problem, so a case can be built once under float64 and once under
float32 without the two sharing cached constraint arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pararealml_tpu import (
    BurgersEquation,
    CahnHilliardEquation,
    ConstrainedProblem,
    ConvectionDiffusionEquation,
    CoordinateSystem,
    DiffusionEquation,
    DirichletBoundaryCondition,
    DiscreteInitialCondition,
    GaussianInitialCondition,
    Mesh,
    NavierStokesEquation,
    NeumannBoundaryCondition,
    ShallowWaterEquation,
    WaveEquation,
    vectorize_bc_function,
)
from pararealml_tpu.operators.fdm import (
    FDMOperator,
    RK4,
    ThreePointCentralDifferenceMethod,
)


def _neumann(n, flux=0.0):
    return NeumannBoundaryCondition(
        lambda x, t: np.full((len(x), n), flux), is_static=True
    )


def _dirichlet(n, value=0.0):
    return DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), n), value), is_static=True
    )


def _gaussian_y0(cp, n, means=None):
    mesh = cp.mesh
    centers = np.array(
        [(lo + hi) / 2.0 for lo, hi in mesh.x_intervals]
    )
    spread = 0.1 * np.diag(
        [(hi - lo) ** 2 for lo, hi in mesh.x_intervals]
    )
    ic = GaussianInitialCondition(
        cp,
        [(centers, spread)] * n,
        means if means is not None else [1.0] + [0.0] * (n - 1),
    )
    return np.asarray(ic.discrete_y_0(True))


def _cartesian_2d(diff_eq, n, bcs, extents=(4.0, 4.0), d_x=0.25):
    mesh = Mesh([(0.0, extents[0]), (0.0, extents[1])], [d_x, d_x])
    return ConstrainedProblem(diff_eq, mesh, bcs)


def diffusion_dirichlet_neumann():
    cp = _cartesian_2d(
        DiffusionEquation(2),
        1,
        [(_dirichlet(1, 1.5),) * 2, (_neumann(1),) * 2],
        extents=(10.0, 10.0),
        d_x=0.5,
    )
    return cp, _gaussian_y0(cp, 1, [1000.0]), 0.01, 8


def diffusion_flux_neumann():
    cp = _cartesian_2d(
        DiffusionEquation(2, 0.3), 1, [(_neumann(1, 0.5),) * 2] * 2
    )
    return cp, _gaussian_y0(cp, 1), 0.01, 8


def diffusion_rectangular():
    cp = _cartesian_2d(
        DiffusionEquation(2, 0.3),
        1,
        [(_neumann(1),) * 2] * 2,
        extents=(4.0, 8.0),
    )
    return cp, _gaussian_y0(cp, 1), 0.01, 8


def convection_diffusion():
    cp = _cartesian_2d(
        ConvectionDiffusionEquation(2, [0.4, -0.2], 0.3),
        1,
        [(_neumann(1, 0.2),) * 2] * 2,
        extents=(8.0, 4.0),
    )
    return cp, _gaussian_y0(cp, 1), 0.01, 8


def wave_dirichlet():
    cp = _cartesian_2d(
        WaveEquation(2, 1.5), 2, [(_dirichlet(2),) * 2, (_neumann(2),) * 2]
    )
    return cp, _gaussian_y0(cp, 2), 0.02, 6


def wave_neumann():
    cp = _cartesian_2d(WaveEquation(2, 1.5), 2, [(_neumann(2),) * 2] * 2)
    return cp, _gaussian_y0(cp, 2), 0.02, 6


def burgers_neumann():
    cp = _cartesian_2d(
        BurgersEquation(2, 100.0), 2, [(_neumann(2),) * 2] * 2
    )
    return cp, _gaussian_y0(cp, 2, [0.5, 0.1]), 0.01, 8


def shallow_water_neumann():
    cp = _cartesian_2d(
        ShallowWaterEquation(0.5), 3, [(_neumann(3),) * 2] * 2
    )
    return cp, _gaussian_y0(cp, 3, [1.0, 0.0, 0.0]), 0.002, 8


def _cahn_hilliard(dirichlet):
    bcs = (
        [(_dirichlet(2),) * 2, (_neumann(2),) * 2]
        if dirichlet
        else [(_neumann(2),) * 2] * 2
    )
    mesh = Mesh([(0.0, 1.0), (0.0, 1.0)], [1.0 / 16, 1.0 / 16])
    cp = ConstrainedProblem(CahnHilliardEquation(2), mesh, bcs)
    rng = np.random.default_rng(0)
    ic = DiscreteInitialCondition(
        cp, rng.uniform(-0.5, 0.5, (17, 17, 2)), vertex_oriented=True
    )
    return cp, np.asarray(ic.discrete_y_0(True)), 1e-4, 6


def cahn_hilliard_neumann():
    return _cahn_hilliard(False)


def cahn_hilliard_dirichlet():
    return _cahn_hilliard(True)


def navier_stokes_lid():
    mesh = Mesh([(-1.0, 1.0), (0.0, 2.0)], [0.125, 0.125])

    def dirichlet(values):
        return DirichletBoundaryCondition(
            vectorize_bc_function(lambda x, t: values), is_static=True
        )

    walls = dirichlet([0.0, 0.0, None, None])
    bcs = [
        (dirichlet([1.0, 0.1, None, None]), walls),
        (walls, walls),
    ]
    cp = ConstrainedProblem(NavierStokesEquation(500.0), mesh, bcs)
    return cp, np.zeros(cp.y_shape(True)), 0.01, 6


def _polar(diff_eq, n, means, d_t, dirichlet=False):
    mesh = Mesh(
        [(2.5, 7.5), (0.0, 2 * np.pi)],
        [0.25, np.pi / 20.0],
        CoordinateSystem.POLAR,
    )
    bcs = [
        (_dirichlet(n) if dirichlet else _neumann(n),) * 2,
        (_neumann(n),) * 2,
    ]
    cp = ConstrainedProblem(diff_eq, mesh, bcs)
    ic = GaussianInitialCondition(
        cp, [(np.array([5.0, np.pi]), np.eye(2))] * n, means
    )
    return cp, np.asarray(ic.discrete_y_0(True)), d_t, 6


def polar_wave():
    return _polar(WaveEquation(2), 2, [1.0, 0.0], 0.001)


def polar_wave_dirichlet():
    return _polar(WaveEquation(2), 2, [1.0, 0.0], 0.001, dirichlet=True)


def polar_burgers():
    return _polar(BurgersEquation(2, 100.0), 2, [0.5, 0.1], 0.001)


def polar_shallow_water():
    return _polar(ShallowWaterEquation(0.5), 3, [1.0, 0.0, 0.0], 0.0005)


def polar_cahn_hilliard():
    return _polar(CahnHilliardEquation(2), 2, [0.5, 0.0], 0.0005)


def _cartesian_3d(diff_eq, n, mixed):
    mesh = Mesh([(0.0, 1.0)] * 3, [0.125] * 3)
    if mixed:
        bcs = [(_dirichlet(n, 0.1), _neumann(n, 0.05))] * 3
    else:
        bcs = [(_neumann(n),) * 2] * 3
    cp = ConstrainedProblem(diff_eq, mesh, bcs)
    return cp, _gaussian_y0(cp, n), 0.001, 4


def diffusion_3d_neumann():
    return _cartesian_3d(DiffusionEquation(3, 0.5), 1, False)


def wave_3d_mixed():
    return _cartesian_3d(WaveEquation(3), 2, True)


def burgers_3d_neumann():
    return _cartesian_3d(BurgersEquation(3, 100.0), 3, False)


CARTESIAN_2D = {
    "diffusion_dirichlet_neumann": diffusion_dirichlet_neumann,
    "diffusion_flux_neumann": diffusion_flux_neumann,
    "diffusion_rectangular": diffusion_rectangular,
    "convection_diffusion": convection_diffusion,
    "wave_dirichlet": wave_dirichlet,
    "wave_neumann": wave_neumann,
    "burgers_neumann": burgers_neumann,
    "shallow_water_neumann": shallow_water_neumann,
    "cahn_hilliard_neumann": cahn_hilliard_neumann,
    "cahn_hilliard_dirichlet": cahn_hilliard_dirichlet,
    "navier_stokes_lid": navier_stokes_lid,
}

POLAR_AND_3D = {
    "polar_wave": polar_wave,
    "polar_wave_dirichlet": polar_wave_dirichlet,
    "polar_burgers": polar_burgers,
    "polar_shallow_water": polar_shallow_water,
    "polar_cahn_hilliard": polar_cahn_hilliard,
    "diffusion_3d_neumann": diffusion_3d_neumann,
    "wave_3d_mixed": wave_3d_mixed,
    "burgers_3d_neumann": burgers_3d_neumann,
}

# the stream-function Jacobi solve stops at its tolerance (1e-3), which
# float32 and float64 reach after different iteration counts
_F32_TOLERANCE = {"navier_stokes_lid": 1e-3}


def _operator(d_t):
    return FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), d_t)


def _trajectory(builder, x64):
    with jax.enable_x64(x64):
        cp, y_0, d_t, steps = builder()
        fn, _ = _operator(d_t).trajectory_function(cp, (0.0, steps * d_t))
        dtype = jnp.float64 if x64 else jnp.float32
        y_0 = jnp.asarray(y_0, dtype)
        return np.asarray(jax.jit(fn)(y_0, jnp.asarray(0.0, dtype)))


def check_float32_trajectory(name, builder):
    """The float32 generic trajectory agrees with the float64 solve to
    float32 rounding (1e-4 of the state scale over a few steps)."""
    ys_64 = _trajectory(builder, True)
    ys_32 = _trajectory(builder, False)
    assert ys_32.dtype == np.float32
    assert ys_32.shape == ys_64.shape
    assert np.all(np.isfinite(ys_32))
    scale = max(1.0, float(np.abs(ys_64).max()))
    atol = _F32_TOLERANCE.get(name, 1e-4) * scale
    np.testing.assert_allclose(ys_32, ys_64, rtol=0.0, atol=atol)


def check_ends_match_last_frame(builder):
    """``ends_function`` (the carry-only scan) reproduces the
    trajectory's final frame in float32."""
    with jax.enable_x64(False):
        cp, y_0, d_t, steps = builder()
        op = _operator(d_t)
        interval = (0.0, steps * d_t)
        fn, _ = op.trajectory_function(cp, interval)
        ends = op.ends_function(cp, interval)
        y_0 = jnp.asarray(y_0, jnp.float32)
        t_0 = jnp.asarray(0.0, jnp.float32)
        last = np.asarray(jax.jit(fn)(y_0, t_0))[-1]
        end = np.asarray(jax.jit(ends)(y_0, t_0))
    scale = max(1.0, float(np.abs(last).max()))
    np.testing.assert_allclose(end, last, rtol=0.0, atol=1e-6 * scale)


def check_vmapped_ends_match_calls(builder):
    """``vmap`` over a batch of slices (as Parareal batches them per
    device) gives each slice's unbatched end state."""
    with jax.enable_x64(False):
        cp, y_0, d_t, steps = builder()
        ends = _operator(d_t).ends_function(cp, (0.0, steps * d_t))
        base = jnp.asarray(y_0, jnp.float32)
        batch = jnp.stack([base, 0.9 * base, 1.1 * base])
        t_starts = jnp.asarray([0.0, d_t, 2 * d_t], jnp.float32)
        batched = np.asarray(jax.jit(jax.vmap(ends))(batch, t_starts))
        single = jax.jit(ends)
        calls = np.stack(
            [np.asarray(single(batch[k], t_starts[k])) for k in range(3)]
        )
    scale = max(1.0, float(np.abs(calls).max()))
    np.testing.assert_allclose(batched, calls, rtol=0.0, atol=1e-6 * scale)
