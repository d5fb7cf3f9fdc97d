"""The float32 generic FDM path on 2D Cartesian grids: trajectories against
float64, end states against the last frame, and vmapped end states
against per-slice calls (the shape Parareal batches slices in)."""

import pytest

from tests.operators.fdm.generic_family_cases import (
    CARTESIAN_2D,
    check_ends_match_last_frame,
    check_float32_trajectory,
    check_vmapped_ends_match_calls,
)


@pytest.mark.parametrize("name", sorted(CARTESIAN_2D))
def test_float32_trajectory_matches_float64(name):
    check_float32_trajectory(name, CARTESIAN_2D[name])


@pytest.mark.parametrize("name", sorted(CARTESIAN_2D))
def test_ends_function_matches_last_frame(name):
    check_ends_match_last_frame(CARTESIAN_2D[name])


@pytest.mark.parametrize("name", sorted(CARTESIAN_2D))
def test_vmapped_ends_match_per_slice_calls(name):
    check_vmapped_ends_match_calls(CARTESIAN_2D[name])
