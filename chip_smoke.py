"""Smoke test of the FDM + Parareal main path on one NVIDIA GPU.

Run from the repository root::

    python chip_smoke.py          # one GPU: phases 0-4
    python chip_smoke.py --four   # four GPUs: the multi-device phase only

Phases (each one raises, and the script exits non-zero, on any failure):

0. environment: the card's name and power limit, versions, which
   optional packages are installed; exits unless JAX's first device is
   a GPU. The compile cache goes where ``JAX_COMPILATION_CACHE_DIR``
   says, or else to ``<repo>/.jax_cache``.
1. parity: every case of ``tests/parity_cases.py`` in float32 on the
   card against the float64 fixtures of the original NumPy library.
2. flagship: the upstream diffusion_2d_parareal configuration (21x21
   grid, RK4, fine d_t 1e-3, coarse 1e-2, T=40, tolerance 2.5e-3, 8
   slices): fine, coarse and Parareal solves, compared with the host
   CPU backend and with each other, with warm times.
3. nonlinear: the 2D viscous Burgers fine solve against the CPU backend.
4. large grid: 2D diffusion at 2049^2 with zero-flux boundaries for 100
   RK4 steps: finite, heat-conserving, and equal to the CPU backend
   over the first 10 steps.
5. ``--four``: Parareal over 4 cards (2 slices per card, and the
   default of one slice per card), spatial decomposition of an
   uneven 2050-row grid over 4 cards, and space-time Parareal on a
   (2, 2) mesh, each against its single-device counterpart.

Findings go to earlier lines; the last line of standard output is one
JSON object naming the device, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
OPTIONAL_PACKAGES = ("sympy", "matplotlib", "flax", "sklearn")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The problem sizes of each phase. ``FULL`` is what the script runs;
    the tests run ``TINY`` on the CPU."""

    flagship_t_end: float = 40.0
    flagship_d_x: float = 0.5
    burgers_t_end: float = 200.0
    large_grid_vertices: int = 2049
    large_grid_steps: int = 100
    large_grid_cpu_steps: int = 10
    four_grid_rows: int = 2050
    timing_repeats: int = 3
    # None runs every case of tests/parity_cases.py
    parity_cases: Optional[Tuple[str, ...]] = None


FULL = Sizes()
TINY = Sizes(
    flagship_t_end=0.8,
    flagship_d_x=2.5,
    burgers_t_end=0.5,
    large_grid_vertices=33,
    large_grid_steps=12,
    large_grid_cpu_steps=4,
    four_grid_rows=34,
    timing_repeats=1,
    parity_cases=("lorenz", "wave"),
)

FLAGSHIP_TOLERANCE = 2.5e-3
FLAGSHIP_FINE_D_T = 1e-3
FLAGSHIP_COARSE_D_T = 1e-2
FLAGSHIP_SLICES = 8


def log(*args) -> None:
    print(*args, flush=True)


class CheckFailed(AssertionError):
    """A comparison exceeded its stated bound."""


def check(name: str, value: float, bound: float, why: str) -> None:
    """Prints one comparison beside its bound and raises if it fails."""
    ok = bool(np.isfinite(value)) and value <= bound
    log(
        f"  [{'ok' if ok else 'FAIL'}] {name}: {value:.3e} "
        f"(bound {bound:.3e}: {why})"
    )
    if not ok:
        raise CheckFailed(f"{name}: {value!r} exceeds {bound!r}")


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


# -- phase 0: environment -----------------------------------------------------


def configure_compile_cache(environ=os.environ) -> str:
    """Keeps JAX's persistent compile cache where
    ``JAX_COMPILATION_CACHE_DIR`` says, or else at the fixed path
    ``<repo>/.jax_cache`` (a fixed path, because the path is part of
    the cache key). Returns the directory in use."""
    import jax

    directory = environ.get("JAX_COMPILATION_CACHE_DIR")
    if not directory:
        directory = os.path.join(REPO_DIR, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", directory)
    return directory


def gpu_identity() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        result = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as error:
        return f"nvidia-smi unavailable ({error.__class__.__name__})"
    return result.stdout.strip() or result.stderr.strip()


def require_gpu(devices) -> None:
    """Refuses to run anywhere but on a GPU: neither this script nor
    the bench falls back to the CPU."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(
            f"JAX found no GPU (first device platform: "
            f"{platform!r}); nothing was measured"
        )


def keep_cpu_backend() -> None:
    """The comparisons run the same program on the host CPU backend, so
    a platform list that leaves it out gets it appended (after the GPU,
    which stays the default device)."""
    import jax

    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")


def phase_environment(
    require: Callable = require_gpu,
) -> Dict[str, object]:
    import jax
    import jaxlib

    log("== phase 0: environment")
    keep_cpu_backend()
    identity = gpu_identity()
    log(f"nvidia-smi: {identity}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    devices = jax.devices()
    log(f"devices: {devices}")
    for name in OPTIONAL_PACKAGES:
        found = importlib.util.find_spec(name) is not None
        log(f"  optional package {name}: {'found' if found else 'absent'}")
    require(devices)
    log(f"compile cache: {configure_compile_cache()}")
    return {"identity": identity, "devices": devices}


# -- helpers ------------------------------------------------------------------


def cpu_device():
    import jax

    return jax.devices("cpu")[0]


def warm_median_time(fn: Callable, *args, repeats: int = 3) -> float:
    """Median wall time of ``fn(*args)`` over ``repeats`` calls after a
    warm-up call, each ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - start)
    return statistics.median(samples)


def memory_line(jitted: Callable, *args) -> str:
    analysis = jitted.lower(*args).compile().memory_analysis()
    if analysis is None:
        return "memory_analysis: not available"
    fields = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return "memory_analysis: " + ", ".join(
        f"{field}={getattr(analysis, field, 'n/a')}" for field in fields
    )


def peak_bytes(device) -> Optional[int]:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# -- phase 1: parity against the original library -----------------------------


def phase_parity(cases: Optional[Sequence[str]] = None) -> None:
    """Every parity case in float32 on the default device and on the CPU
    backend, each against the float64 fixture. The card's error may be
    at most twice the CPU's float32 error (both round in float32; fusion
    on the card reorders sums), with a floor of 1e-6 of the state's
    scale for cases whose CPU error is near zero."""
    import jax

    import pararealml_tpu
    import pararealml_tpu.operators.fdm as fdm
    from tests.parity_cases import equation_cases, solve_fdm_trajectory

    log("== phase 1: parity with the original library (float32)")
    path = os.path.join(
        REPO_DIR, "tests", "fixtures", "reference_trajectories.npz"
    )
    all_cases = equation_cases()
    names = sorted(all_cases) if cases is None else list(cases)
    with np.load(path) as fixtures:
        for name in names:
            expected = fixtures[f"trajectory_{name}"]
            case = all_cases[name]
            device_y = solve_fdm_trajectory(
                vars(pararealml_tpu), vars(fdm), case
            )
            with jax.default_device(cpu_device()):
                cpu_y = solve_fdm_trajectory(
                    vars(pararealml_tpu), vars(fdm), case
                )
            if device_y.shape != expected.shape:
                raise CheckFailed(
                    f"{name}: shape {device_y.shape} != {expected.shape}"
                )
            scale = max(1.0, float(np.abs(expected).max()))
            device_err = max_abs_diff(device_y, expected)
            cpu_err = max_abs_diff(cpu_y, expected)
            check(
                f"parity {name} max |device - reference|",
                device_err,
                max(2.0 * cpu_err, 1e-6 * scale),
                f"2x CPU float32 error {cpu_err:.3e}, floor 1e-6*scale",
            )


# -- phase 2: the flagship configuration --------------------------------------


def flagship_ivp(t_end: float, d_x: float = 0.5):
    """The upstream diffusion_2d_parareal problem
    (examples/diffusion_2d_parareal.py)."""
    import pararealml_tpu as prml

    mesh = prml.Mesh([(0.0, 10.0), (0.0, 10.0)], [d_x, d_x])
    dirichlet = prml.DirichletBoundaryCondition(
        lambda x, t: np.full((len(x), 1), 1.5), is_static=True
    )
    neumann = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.DiffusionEquation(2),
        mesh,
        [(dirichlet, dirichlet), (neumann, neumann)],
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.array([5.0, 5.0]), np.eye(2))], [1000.0]
    )
    return prml.InitialValueProblem(cp, (0.0, t_end), ic)


def flagship_operators(devices=None, num_time_slices=FLAGSHIP_SLICES):
    """Fine, coarse and Parareal operators of the flagship; a
    ``num_time_slices`` of None leaves Parareal its default of one slice
    per device."""
    from pararealml_tpu.operators.fdm import (
        FDMOperator,
        RK4,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu.operators.parareal import PararealOperator

    f = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), FLAGSHIP_FINE_D_T
    )
    g = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), FLAGSHIP_COARSE_D_T
    )
    p = PararealOperator(
        f,
        g,
        FLAGSHIP_TOLERANCE,
        num_time_slices=num_time_slices,
        devices=devices,
    )
    return f, g, p


def time_trajectory(
    label: str, operator, ivp, identity: str, repeats: int
) -> float:
    """Warm time of the operator's jitted trajectory program alone,
    printed beside the card. It leaves out what ``solve()`` adds: the
    build (for Parareal, the affine propagator), compilation and the
    host transfer."""
    import jax
    import jax.numpy as jnp

    cp = ivp.constrained_problem
    fn, t = operator.trajectory_function(cp, ivp.t_interval)
    jitted = jax.jit(fn)
    y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))
    t_0 = jnp.asarray(ivp.t_interval[0], y_0.dtype)
    elapsed = warm_median_time(jitted, y_0, t_0, repeats=repeats)
    steps = len(t)  # the output times exclude the initial one
    log(
        f"  {label} program: {elapsed:.6f} s warm median of {repeats} "
        f"({steps} steps, {elapsed / steps * 1e6:.3f} us/step) "
        f"on [{identity}]"
    )
    log(f"  {label} {memory_line(jitted, y_0, t_0)}")
    return elapsed


def phase_flagship(sizes: Sizes, identity: str) -> Dict[str, float]:
    import jax

    log("== phase 2: flagship diffusion_2d Parareal")
    ivp = flagship_ivp(sizes.flagship_t_end, sizes.flagship_d_x)
    f, g, p = flagship_operators()
    operators = {"fine": f, "coarse": g, "parareal": p}

    # the first solve() of a fresh operator pays what a user solving once
    # pays: the build (for Parareal, the affine propagator), compilation,
    # the run and the host transfer
    first = {}
    trajectories = {}
    for label, operator in operators.items():
        start = time.perf_counter()
        trajectories[label] = operator.solve(ivp).discrete_y()
        first[label] = time.perf_counter() - start
        log(
            f"  {label} first solve() (build, compile, run, host "
            f"transfer): {first[label]:.6f} s on [{identity}]"
        )
    fine_y = trajectories["fine"]
    coarse_y = trajectories["coarse"]
    parareal_y = trajectories["parareal"]
    with jax.default_device(cpu_device()):
        cpu_f, _, _ = flagship_operators()
        cpu_fine_y = cpu_f.solve(ivp).discrete_y()

    scale = max(1.0, float(np.abs(cpu_fine_y).max()))
    log(f"  state scale max|y| = {scale:.3e}, fine steps {len(fine_y)}")
    check(
        "fine: max |device - CPU backend|",
        max_abs_diff(fine_y, cpu_fine_y),
        1e-5 * scale,
        "same float32 program on both backends; diffusion damps "
        "rounding differences, 1e-5 of the state scale",
    )
    stride = round(FLAGSHIP_COARSE_D_T / FLAGSHIP_FINE_D_T)
    check(
        "coarse vs fine at coarse times: max diff",
        max_abs_diff(coarse_y, fine_y[stride - 1::stride]),
        1e-3 * scale,
        "RK4 truncation of the 10x coarser step, 1e-3 of the scale",
    )
    check(
        "parareal vs device fine: max diff",
        max_abs_diff(parareal_y, fine_y),
        2.0 * FLAGSHIP_TOLERANCE,
        "twice the termination tolerance on border updates",
    )

    # a warm solve() reuses the operator's cached program: what each
    # further solve of the same problem costs, host transfer included
    repeats = sizes.timing_repeats
    warm = {}
    for label, operator in operators.items():
        warm[label] = warm_median_time(
            lambda op=operator: op.solve(ivp).discrete_y(),
            repeats=repeats,
        )
        log(
            f"  {label} warm solve() (run, host transfer): "
            f"{warm[label]:.6f} s median of {repeats} on [{identity}]"
        )
    log(
        "  parareal speed-up over the fine solve: "
        f"{warm['fine'] / warm['parareal']:.3f}x warm solve(), "
        f"{first['fine'] / first['parareal']:.3f}x first solve()"
    )
    for label, operator in operators.items():
        time_trajectory(label, operator, ivp, identity, repeats)
    return warm


# -- phase 3: nonlinear system ------------------------------------------------


def burgers_ivp(t_end: float):
    """2D viscous Burgers, Re=100, zero-flux faces, Gaussian bumps on a
    21x21 grid (the upstream burgers example's settings in 2D)."""
    import pararealml_tpu as prml

    mesh = prml.Mesh([(0.0, 5.0)] * 2, [0.25] * 2)
    neumann = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 2)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.BurgersEquation(2, 100.0), mesh, [(neumann, neumann)] * 2
    )
    ic = prml.GaussianInitialCondition(
        cp, [(np.full(2, 2.5), 0.75 * np.eye(2))] * 2, [1.0, 0.5]
    )
    return prml.InitialValueProblem(cp, (0.0, t_end), ic)


def phase_nonlinear(sizes: Sizes, identity: str) -> float:
    import jax

    from pararealml_tpu.operators.fdm import (
        FDMOperator,
        RK4,
        ThreePointCentralDifferenceMethod,
    )

    log("== phase 3: 2D Burgers fine solve")
    ivp = burgers_ivp(sizes.burgers_t_end)

    def operator():
        return FDMOperator(
            RK4(), ThreePointCentralDifferenceMethod(), 0.0025
        )

    y = operator().solve(ivp).discrete_y()
    with jax.default_device(cpu_device()):
        cpu_y = operator().solve(ivp).discrete_y()
    scale = max(1.0, float(np.abs(cpu_y).max()))
    check(
        "burgers fine: max |device - CPU backend|",
        max_abs_diff(y, cpu_y),
        1e-4 * scale,
        "same float32 program; viscous decay bounds rounding growth, "
        "1e-4 of the state scale",
    )
    return time_trajectory(
        "burgers fine", operator(), ivp, identity, sizes.timing_repeats
    )


# -- phase 4: large grid ------------------------------------------------------


def large_grid_ivp(rows: int, cols: int, steps: int):
    """2D diffusion (D=1) on a unit-spaced ``rows x cols`` vertex grid
    with zero-flux faces and a wide Gaussian; d_t=0.2 is inside RK4's
    stability limit of about 0.35 for this spacing."""
    import pararealml_tpu as prml

    mesh = prml.Mesh(
        [(0.0, float(rows - 1)), (0.0, float(cols - 1))], [1.0, 1.0]
    )
    neumann = prml.NeumannBoundaryCondition(
        lambda x, t: np.zeros((len(x), 1)), is_static=True
    )
    cp = prml.ConstrainedProblem(
        prml.DiffusionEquation(2), mesh, [(neumann, neumann)] * 2
    )
    spread = (min(rows, cols) / 8.0) ** 2
    ic = prml.GaussianInitialCondition(
        cp,
        [(np.array([(rows - 1) / 2.0, (cols - 1) / 3.0]),
          spread * np.eye(2))],
        [spread],
    )
    return prml.InitialValueProblem(cp, (0.0, steps * 0.2), ic)


def large_grid_operator(spatial_mesh=None):
    from pararealml_tpu.operators.fdm import (
        FDMOperator,
        RK4,
        ThreePointCentralDifferenceMethod,
    )

    return FDMOperator(
        RK4(),
        ThreePointCentralDifferenceMethod(),
        0.2,
        spatial_mesh=spatial_mesh,
    )


def trapezoid_heat(y: np.ndarray) -> np.ndarray:
    """Total heat of each frame under the trapezoid weights that the
    zero-flux three-point scheme conserves."""
    weights_0 = np.ones(y.shape[-3])
    weights_0[[0, -1]] = 0.5
    weights_1 = np.ones(y.shape[-2])
    weights_1[[0, -1]] = 0.5
    return np.einsum(
        "...ijc,i,j->...", np.asarray(y, np.float64), weights_0, weights_1
    )


def phase_large_grid(sizes: Sizes, identity: str) -> float:
    import jax

    n = sizes.large_grid_vertices
    log(f"== phase 4: large grid {n}x{n}, {sizes.large_grid_steps} steps")
    ivp = large_grid_ivp(n, n, sizes.large_grid_steps)
    y = large_grid_operator().solve(ivp).discrete_y()
    if not np.all(np.isfinite(y)):
        raise CheckFailed("large grid: non-finite values")
    log(f"  all {y.size} values finite")
    heat_0 = float(trapezoid_heat(ivp.initial_condition.discrete_y_0(True)))
    heat = trapezoid_heat(y)
    check(
        "large grid: max relative heat drift",
        float(np.max(np.abs(heat - heat_0)) / abs(heat_0)),
        1e-5,
        "zero-flux faces conserve trapezoid-weighted heat exactly; "
        "float32 rounding of 100 steps",
    )

    short = large_grid_ivp(n, n, sizes.large_grid_cpu_steps)
    with jax.default_device(cpu_device()):
        cpu_y = large_grid_operator().solve(short).discrete_y()
    scale = max(1.0, float(np.abs(cpu_y).max()))
    check(
        f"large grid first {sizes.large_grid_cpu_steps} steps: "
        "max |device - CPU backend|",
        max_abs_diff(y[: sizes.large_grid_cpu_steps], cpu_y),
        1e-6 * scale,
        "same float32 stencil program, a few ulps of the scale",
    )
    elapsed = time_trajectory(
        "large grid", large_grid_operator(), ivp, identity,
        sizes.timing_repeats,
    )
    log(f"  peak_bytes_in_use: {peak_bytes(jax.devices()[0])}")
    return elapsed


# -- phase 5: four devices ----------------------------------------------------


def phase_four(sizes: Sizes, devices: Sequence) -> None:
    """Parareal over the time axis, spatial decomposition, and the
    space-time mesh, each across four devices against one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pararealml_tpu.operators.fdm import (
        FDMOperator,
        RK4,
        ThreePointCentralDifferenceMethod,
    )
    from pararealml_tpu.operators.parareal import (
        SpaceTimePararealOperator,
    )
    from pararealml_tpu.utils.distributed import space_mesh

    devices = list(devices)
    if len(devices) != 4:
        raise SystemExit(f"--four needs 4 devices, found {len(devices)}")
    log("== phase 5a: flagship Parareal over 4 devices")
    ivp = flagship_ivp(sizes.flagship_t_end, sizes.flagship_d_x)
    cp = ivp.constrained_problem
    f, _, _ = flagship_operators()
    fine_y = f.solve(ivp).discrete_y()
    y_0 = jnp.asarray(ivp.initial_condition.discrete_y_0(True))
    # 8 slices batch 2 per device; the default slice count (None) is one
    # slice per device
    for slices in (FLAGSHIP_SLICES, None):
        n = slices or len(devices)
        log(f"  {n} slices over {len(devices)} devices")
        _, _, p4 = flagship_operators(devices, slices)
        _, _, p1 = flagship_operators(devices[:1], n)
        fn4, _ = p4.trajectory_function(cp, ivp.t_interval)
        out4 = fn4(y_0, jnp.asarray(0.0, y_0.dtype))
        log(
            "  output sharded over: "
            f"{sorted(d.id for d in out4.sharding.device_set)}"
        )
        y4 = np.asarray(out4)
        y1 = p1.solve(ivp).discrete_y()
        check(
            f"parareal {n} slices, 4 devices vs 1 device: max diff",
            max_abs_diff(y4, y1),
            1e-5 * max(1.0, float(np.abs(y1).max())),
            "same schedule; only the placement of slices differs",
        )
        check(
            f"parareal {n} slices, 4 devices vs fine: max diff",
            max_abs_diff(y4, fine_y),
            2.0 * FLAGSHIP_TOLERANCE,
            "twice the termination tolerance on border updates",
        )

    rows = sizes.four_grid_rows
    cols = rows - 1
    log(f"== phase 5b: spatial decomposition of {rows}x{cols} over 4")
    ivp = large_grid_ivp(rows, cols, sizes.large_grid_cpu_steps)
    mesh = space_mesh(4, devices=devices)
    log(f"  mesh devices: {[d.id for d in mesh.devices.flat]}")
    y_sharded = large_grid_operator(mesh).solve(ivp).discrete_y()
    with jax.default_device(devices[0]):
        y_single = large_grid_operator().solve(ivp).discrete_y()
    check(
        "spatially decomposed vs single device: max diff",
        max_abs_diff(y_sharded, y_single),
        1e-6,
        "the same stencil program split by the SPMD partitioner",
    )

    log("== phase 5c: space-time Parareal on a (2, 2) mesh")
    ivp = flagship_ivp(0.4, 0.5)
    fine = FDMOperator(RK4(), ThreePointCentralDifferenceMethod(), 0.005)
    coarse = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.025
    )
    mesh_2d = Mesh(np.array(devices).reshape(2, 2), ("time", "space"))
    log(f"  mesh: {dict(mesh_2d.shape)} over {[d.id for d in devices]}")
    st = SpaceTimePararealOperator(
        fine, coarse, termination_condition=1e-4, num_time_slices=4,
        mesh=mesh_2d,
    )
    y_st = st.solve(ivp).discrete_y()
    fine_y = fine.solve(ivp).discrete_y()
    check(
        "space-time parareal vs fine: max diff",
        max_abs_diff(y_st, fine_y),
        1e-2,
        "termination tolerance 1e-4 on border RMS, over 4 slices",
    )
    for device in devices:
        log(f"  device {device.id} peak_bytes_in_use: {peak_bytes(device)}")


# -- driver -------------------------------------------------------------------


def result_line(devices) -> str:
    """The final line: the device as JAX reports it."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def main(
    argv: Optional[Sequence[str]] = None,
    sizes: Sizes = FULL,
    require: Callable = require_gpu,
) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four",
        action="store_true",
        help="run only the four-device phase (needs 4 GPUs)",
    )
    args = parser.parse_args(argv)
    if REPO_DIR not in sys.path:
        sys.path.insert(0, REPO_DIR)

    environment = phase_environment(require)
    devices = environment["devices"]
    identity = environment["identity"]
    if args.four:
        phase_four(sizes, devices[:4])
    else:
        phase_parity(sizes.parity_cases)
        phase_flagship(sizes, identity)
        phase_nonlinear(sizes, identity)
        phase_large_grid(sizes, identity)
    log(f"nvidia-smi: {identity}")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
