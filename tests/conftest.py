"""Test configuration: run JAX on CPU with 8 virtual devices (so
multi-device Parareal sharding is exercised without several
accelerators) and enable float64 so numerical oracles can be checked at
reference precision.

Plugins may import jax before this conftest runs, so environment
variables are too late; the config updates below work as long as no
backend has been initialized yet.

The persistent compilation cache (``.jax_cache/``, gitignored) is the
suite's main speed lever on this backend: XLA:CPU compilation dominates
most tests' wall time, and the cache is hit both across runs and WITHIN
a cold run whenever two tests build the same program (the suite
re-creates many identical operators per test). It is machine-local by
design — XLA:CPU AOT executables encode host CPU features — so it must
never be shared between machines; ``PRML_NO_JAX_CACHE=1`` disables it,
and a ``JAX_COMPILATION_CACHE_DIR`` set by the caller takes its place.
XLA logs a spurious machine-feature-mismatch error on every AOT cache
load (it records tuning pseudo-features like ``prefer-no-scatter`` as
if they were host features), so error-level C++ logs are silenced
unless the caller set a level explicitly.
"""

import os

if "PRML_NO_JAX_CACHE" not in os.environ:
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

if "PRML_NO_JAX_CACHE" not in os.environ:
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
        )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
