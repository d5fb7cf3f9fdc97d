"""Smoke tests executing every example script end-to-end.

Each example runs unmodified in a subprocess with ``PRML_SMOKE=1``,
which makes ``examples/_common.py`` shrink the expensive knobs (time
horizon, training epochs, data-set size) through the public API; the
scripts themselves stay identical to their full-scale configurations.
The reference never exercises its examples in CI
(/root/reference/.github/workflows/build.yml runs only tests/), so a
signature drift there ships silently — this harness closes that gap.

Run in a subprocess (not ``runpy``) so each example gets a fresh JAX
runtime on a virtual 8-device CPU mesh, which the space-sharded and
space-time examples need.
"""
import os
import subprocess
import sys

import pytest

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples",
)

EXAMPLE_SCRIPTS = sorted(
    name
    for name in os.listdir(EXAMPLES_DIR)
    if name.endswith(".py") and not name.startswith("_")
)


def test_all_examples_are_collected():
    assert len(EXAMPLE_SCRIPTS) >= 30


@pytest.mark.examples
@pytest.mark.parametrize("script", EXAMPLE_SCRIPTS)
def test_example_smoke(script, tmp_path):
    env = dict(os.environ)
    env.update(
        PRML_SMOKE="1",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip(),
    )
    result = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, script)],
        cwd=tmp_path,  # plot outputs land in the test's tmp dir
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert result.returncode == 0, (
        f"{script} failed\nstdout:\n{result.stdout[-3000:]}\n"
        f"stderr:\n{result.stderr[-3000:]}"
    )
