"""Differential parity harness against the reference implementation.

These tests run only where the reference library is available (mounted at
/root/reference); they feed identical random inputs to both
implementations and require agreement to near machine precision. They are
skipped automatically elsewhere (CI), where the oracle-based tests carry
the coverage.
"""

import os
import sys

import numpy as np
import pytest

REFERENCE_PATH = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REFERENCE_PATH, "pararealml")),
    reason="reference implementation not available",
)


@pytest.fixture(scope="module")
def reference():
    if not hasattr(np, "product"):
        np.product = np.prod  # the reference targets an older numpy
    sys.path.insert(0, REFERENCE_PATH)
    try:
        import pararealml as ref
        import pararealml.operators.fdm as ref_fdm

        yield ref, ref_fdm
    finally:
        sys.path.remove(REFERENCE_PATH)


def _meshes(module):
    return {
        "cartesian": module.Mesh(
            [(0.0, 1.0), (0.0, 1.0)], [0.1, 0.1]
        ),
        "polar": module.Mesh(
            [(1.0, 2.0), (0.0, 2.0)],
            [0.1, 0.2],
            module.CoordinateSystem.POLAR,
        ),
        "cylindrical": module.Mesh(
            [(1.0, 2.0), (0.0, 2.0), (0.0, 1.0)],
            [0.2, 0.4, 0.2],
            module.CoordinateSystem.CYLINDRICAL,
        ),
        "spherical": module.Mesh(
            [(1.0, 2.0), (0.0, 2.0), (0.5, 1.5)],
            [0.2, 0.4, 0.2],
            module.CoordinateSystem.SPHERICAL,
        ),
    }


def test_differentiator_ops_match_reference(reference):
    ref, ref_fdm = reference
    import pararealml_tpu as mine
    from pararealml_tpu.operators.fdm import (
        ThreePointCentralDifferenceMethod,
    )

    rng = np.random.default_rng(42)
    my_diff = ThreePointCentralDifferenceMethod()
    ref_diff = ref_fdm.ThreePointCentralDifferenceMethod()

    for name in ("cartesian", "polar", "cylindrical", "spherical"):
        my_mesh = _meshes(mine)[name]
        ref_mesh = _meshes(ref)[name]
        dims = my_mesh.dimensions
        y_vector = rng.standard_normal(
            my_mesh.vertices_shape + (dims,)
        )
        y_scalar = y_vector[..., :1]

        for axis in range(dims):
            mine_out = np.asarray(
                my_diff.gradient(y_scalar, my_mesh, axis)
            )
            ref_out = ref_diff.gradient(y_scalar, ref_mesh, axis)
            assert np.allclose(mine_out, ref_out, atol=1e-10), (
                f"gradient {name} axis {axis}"
            )

        for axis1 in range(dims):
            for axis2 in range(dims):
                mine_out = np.asarray(
                    my_diff.hessian(y_scalar, my_mesh, axis1, axis2)
                )
                ref_out = ref_diff.hessian(
                    y_scalar, ref_mesh, axis1, axis2
                )
                assert np.allclose(mine_out, ref_out, atol=1e-10), (
                    f"hessian {name} axes {axis1},{axis2}"
                )

        assert np.allclose(
            np.asarray(my_diff.divergence(y_vector, my_mesh)),
            ref_diff.divergence(y_vector, ref_mesh),
            atol=1e-10,
        ), f"divergence {name}"

        curl_indices = [0] if dims == 2 else [0, 1, 2]
        for curl_index in curl_indices:
            assert np.allclose(
                np.asarray(
                    my_diff.curl(y_vector, my_mesh, curl_index)
                ),
                ref_diff.curl(y_vector, ref_mesh, curl_index),
                atol=1e-10,
            ), f"curl {name} {curl_index}"

        assert np.allclose(
            np.asarray(my_diff.laplacian(y_scalar, my_mesh)),
            ref_diff.laplacian(y_scalar, ref_mesh),
            atol=1e-10,
        ), f"laplacian {name}"

        if name == "spherical":
            # known reference defect: its spherical vector Laplacian
            # combines the scalar Laplacian of component i with the
            # curvilinear correction terms of a *different* component
            # (numerical_differentiator.py:773-841 — e.g. index 1 pairs
            # lap(y_theta) with the r-component corrections), so its
            # outputs match no standard formula. This implementation
            # uses the textbook assignment, validated by
            # test_numerical_differentiator.py::
            # test_spherical_vector_laplacian against a coordinate-free
            # Cartesian oracle (runs in CI without this harness).
            continue

        for index in range(dims):
            assert np.allclose(
                np.asarray(
                    my_diff.vector_laplacian(y_vector, my_mesh, index)
                ),
                ref_diff.vector_laplacian(y_vector, ref_mesh, index),
                atol=1e-10,
            ), f"vector_laplacian {name} {index}"


def _build_diffusion_problem(module, t_end):
    diff_eq = module.DiffusionEquation(2, 0.25)
    mesh = module.Mesh([(0.0, 5.0), (0.0, 5.0)], [0.25, 0.25])
    bcs = [
        (
            module.DirichletBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 2.0), is_static=True
            ),
            module.DirichletBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        ),
        (
            module.NeumannBoundaryCondition(
                lambda x, t: np.full((len(x), 1), 0.5), is_static=True
            ),
            module.NeumannBoundaryCondition(
                lambda x, t: np.zeros((len(x), 1)), is_static=True
            ),
        ),
    ]
    cp = module.ConstrainedProblem(diff_eq, mesh, bcs)
    ic = module.GaussianInitialCondition(
        cp, [(np.full(2, 2.5), np.eye(2))], [20.0]
    )
    return module.InitialValueProblem(cp, (0.0, t_end), ic)


def test_fdm_solve_matches_reference(reference):
    ref, ref_fdm = reference
    import pararealml_tpu as mine
    from pararealml_tpu.operators.fdm import (
        FDMOperator,
        RK4,
        ThreePointCentralDifferenceMethod,
    )

    my_ivp = _build_diffusion_problem(mine, 0.5)
    ref_ivp = _build_diffusion_problem(ref, 0.5)

    my_solution = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.01
    ).solve(my_ivp)
    ref_solution = ref_fdm.FDMOperator(
        ref_fdm.RK4(), ref_fdm.ThreePointCentralDifferenceMethod(), 0.01
    ).solve(ref_ivp)

    assert np.allclose(
        my_solution.discrete_y(),
        ref_solution.discrete_y(),
        atol=1e-10,
    )


def test_dynamic_bc_solve_matches_reference(reference):
    ref, ref_fdm = reference
    import pararealml_tpu as mine
    from pararealml_tpu.operators.fdm import (
        FDMOperator,
        RK4,
        ThreePointCentralDifferenceMethod,
    )

    def build(module):
        diff_eq = module.DiffusionEquation(1, 0.5)
        mesh = module.Mesh([(0.0, 1.0)], [0.1])
        bcs = [
            (
                module.DirichletBoundaryCondition(
                    lambda x, t: np.full((len(x), 1), t)
                ),
                module.NeumannBoundaryCondition(
                    lambda x, t: np.full((len(x), 1), np.sin(t))
                ),
            )
        ]
        cp = module.ConstrainedProblem(diff_eq, mesh, bcs)
        ic = module.ContinuousInitialCondition(
            cp, lambda x: np.zeros_like(x)
        )
        return module.InitialValueProblem(cp, (0.0, 1.0), ic)

    my_solution = FDMOperator(
        RK4(), ThreePointCentralDifferenceMethod(), 0.05
    ).solve(build(mine))
    ref_solution = ref_fdm.FDMOperator(
        ref_fdm.RK4(), ref_fdm.ThreePointCentralDifferenceMethod(), 0.05
    ).solve(build(ref))

    assert np.allclose(
        my_solution.discrete_y(),
        ref_solution.discrete_y(),
        atol=1e-10,
    )


# -- broader differential coverage -------------------------------------------
# (shared problem builders: tests/parity_cases.py; a vendored-fixture
# subset of these runs without the reference mount in
# tests/test_vendored_parity.py)

from tests.parity_cases import equation_cases, solve_fdm_trajectory  # noqa: E402

_EQUATION_TOLERANCES = {
    # the stream-function anti-Laplacian solve is iterative on both
    # sides (Jacobi to 1e-3 here and in the reference), so trajectories
    # agree to the solver tolerance rather than machine precision
    "navier_stokes": 1e-6,
}


@pytest.mark.parametrize("case_name", sorted(equation_cases()))
def test_fdm_trajectory_matches_reference_per_equation(
    reference, case_name
):
    ref, ref_fdm = reference
    import pararealml_tpu as mine
    import pararealml_tpu.operators.fdm as mine_fdm

    case = equation_cases()[case_name]
    my_y = solve_fdm_trajectory(vars(mine), vars(mine_fdm), case)
    ref_y = solve_fdm_trajectory(vars(ref), vars(ref_fdm), case)
    assert my_y.shape == ref_y.shape
    atol = _EQUATION_TOLERANCES.get(case_name, 1e-9)
    scale = max(1.0, float(np.abs(ref_y).max()))
    assert np.allclose(my_y, ref_y, atol=atol * scale), (
        f"{case_name}: max diff "
        f"{float(np.abs(my_y - ref_y).max()):.3e} "
        f"(scale {scale:.3e})"
    )


@pytest.mark.parametrize(
    "integrator_name",
    [
        "ForwardEulerMethod",
        "ExplicitMidpointMethod",
        "RK4",
        "BackwardEulerMethod",
        "CrankNicolsonMethod",
    ],
)
def test_integrator_matches_reference(reference, integrator_name):
    ref, ref_fdm = reference
    import pararealml_tpu.operators.fdm as mine_fdm

    rng = np.random.default_rng(3)
    y = rng.standard_normal((9, 2))
    d_t = 0.01
    decay = np.array([0.8, 1.3])

    # an autonomous affine rhs so both calling conventions (the
    # reference passes absolute t, this package a static stage offset)
    # describe the same problem
    def ref_rhs(t, y_value):
        return -decay * y_value + 0.5

    def my_rhs(offset, y_value):
        return -decay * y_value + 0.5

    mine_out = np.asarray(
        getattr(mine_fdm, integrator_name)().integral(
            y, d_t, my_rhs, lambda _: None
        )
    )
    ref_out = getattr(ref_fdm, integrator_name)().integral(
        y, 0.0, d_t, ref_rhs, lambda _: None
    )
    # implicit methods solve the update equation iteratively (secant
    # here, scipy.optimize.newton in the reference): same tolerance,
    # different iteration arithmetic
    atol = 1e-12 if integrator_name in (
        "ForwardEulerMethod", "ExplicitMidpointMethod", "RK4"
    ) else 1e-7
    assert np.allclose(mine_out, ref_out, atol=atol)


class _SingleRankComm:
    """Just enough of mpi4py's COMM_WORLD for the reference Parareal's
    degenerate single-process path (its own test suite relies on the
    same degeneration; SURVEY.md section 4)."""

    size = 1
    rank = 0

    def Allgather(self, send_buffer, recv_buffer):
        send = send_buffer[0] if isinstance(send_buffer, list) else send_buffer
        recv = recv_buffer[0] if isinstance(recv_buffer, list) else recv_buffer
        np.copyto(recv, np.asarray(send)[np.newaxis])

    def barrier(self):
        pass


def test_single_slice_parareal_matches_reference(reference):
    ref, ref_fdm = reference
    import pararealml_tpu as mine
    import pararealml_tpu.operators.fdm as mine_fdm
    from pararealml_tpu.operators.parareal import PararealOperator

    import types

    fake_mpi = types.SimpleNamespace(
        COMM_WORLD=_SingleRankComm(), DOUBLE=None
    )
    fake_module = types.SimpleNamespace(MPI=fake_mpi)
    sys.modules.setdefault("mpi4py", fake_module)
    sys.modules["mpi4py"].MPI = fake_mpi
    try:
        from pararealml.operators.parareal import (
            PararealOperator as RefParareal,
        )
    except ImportError:
        pytest.skip("reference parareal not importable")

    case = equation_cases()["lorenz"]
    tolerance = 1e-2

    ref_ivp = case["build"](vars(ref))
    ref_f = ref_fdm.FDMOperator(
        ref_fdm.RK4(),
        ref_fdm.ThreePointCentralDifferenceMethod(),
        case["d_t"],
    )
    ref_g = ref_fdm.FDMOperator(
        ref_fdm.RK4(),
        ref_fdm.ThreePointCentralDifferenceMethod(),
        case["d_t"] * 2,
    )
    ref_y = RefParareal(ref_f, ref_g, tolerance).solve(
        ref_ivp
    ).discrete_y()

    my_ivp = case["build"](vars(mine))
    my_f = mine_fdm.FDMOperator(
        mine_fdm.RK4(),
        mine_fdm.ThreePointCentralDifferenceMethod(),
        case["d_t"],
    )
    my_g = mine_fdm.FDMOperator(
        mine_fdm.RK4(),
        mine_fdm.ThreePointCentralDifferenceMethod(),
        case["d_t"] * 2,
    )
    my_y = PararealOperator(
        my_f, my_g, tolerance, num_time_slices=1
    ).solve(my_ivp).discrete_y()

    assert my_y.shape == ref_y.shape
    assert np.allclose(my_y, ref_y, atol=1e-9)
