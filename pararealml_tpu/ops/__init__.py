from pararealml_tpu.ops.linear_propagator import (
    build_linear_propagator_trajectory,
    equation_system_is_affine,
    linear_propagator_applicable,
    probe_affine_step,
)

__all__ = [
    "build_linear_propagator_trajectory",
    "equation_system_is_affine",
    "linear_propagator_applicable",
    "probe_affine_step",
]
