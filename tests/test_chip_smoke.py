"""Tests of ``chip_smoke.py`` and of the device policy: every phase at a
tiny size on the CPU with the platform check injected, the refusal to
run without a GPU, the compile-cache rule, the exact last line, and the
imports of the main path."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO_DIR, env_update=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_update or {})
    return subprocess.run(
        [sys.executable, *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def _accept_any(devices):
    return None


def test_every_phase_runs_at_tiny_size(capsys):
    with jax.enable_x64(False):
        assert chip_smoke.main([], chip_smoke.TINY, _accept_any) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == chip_smoke.result_line(jax.devices())
    text = "\n".join(lines)
    for phase in range(5):
        assert f"== phase {phase}:" in text
    assert "[FAIL]" not in text
    assert lines[-2].startswith("nvidia-smi: ")


def test_four_device_phase_runs_at_tiny_size(capsys):
    with jax.enable_x64(False):
        assert (
            chip_smoke.main(["--four"], chip_smoke.TINY, _accept_any) == 0
        )
    out = capsys.readouterr().out
    for part in ("5a", "5b", "5c"):
        assert f"== phase {part}:" in out
    assert "[FAIL]" not in out
    assert out.count("peak_bytes_in_use") == 4


def test_check_raises_past_its_bound():
    chip_smoke.check("inside", 1.0, 1.0, "equal is fine")
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("outside", 1.5, 1.0, "too large")
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check("nan", float("nan"), 1.0, "never passes")


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_without_a_gpu_the_script_exits_nonzero():
    result = _run(["chip_smoke.py"])
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
    assert "no GPU" in result.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO_DIR, "chip_smoke.py"), tmp_path)
    result = _run(["chip_smoke.py"], cwd=tmp_path)
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


def test_bench_exits_nonzero_without_a_gpu():
    result = _run(["bench.py"])
    assert result.returncode != 0
    assert "no GPU" in result.stderr


def test_compile_cache_defers_to_the_environment():
    before = jax.config.jax_compilation_cache_dir
    directory = chip_smoke.configure_compile_cache(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}
    )
    assert directory == "/elsewhere"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_a_fixed_repo_path():
    before = jax.config.jax_compilation_cache_dir
    try:
        directory = chip_smoke.configure_compile_cache({})
        assert directory == os.path.join(REPO_DIR, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == directory
        # the same path every time, never a per-process one
        assert chip_smoke.configure_compile_cache({}) == directory
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_last_line_is_the_exact_contract():
    class Device:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Device()])
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line)["device"]["count"] == 1


def test_main_path_imports_no_optional_packages():
    code = (
        "import sys\n"
        "import pararealml_tpu\n"
        "import pararealml_tpu.operators.fdm\n"
        "import pararealml_tpu.operators.ode\n"
        "import pararealml_tpu.operators.parareal\n"
        "loaded = [m for m in ('sympy', 'matplotlib', 'flax', 'msgpack',"
        " 'sklearn') if m in sys.modules]\n"
        "print(loaded)\n"
    )
    result = _run(["-c", code])
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "[]"


@pytest.fixture
def gpu_environment():
    """Environment for a child process that may use the GPU; skips
    unless the machine has one."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_gpu(gpu_environment):
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=REPO_DIR,
        env=gpu_environment,
        capture_output=True,
        text=True,
        timeout=1200,
    )
    assert result.returncode == 0, result.stdout[-3000:]
    device = json.loads(result.stdout.strip().splitlines()[-1])["device"]
    assert device["platform"] == "gpu"
