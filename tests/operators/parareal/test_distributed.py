"""Two-process DCN smoke test for the multi-host Parareal path.

Spawns two CPU processes that connect through
``pararealml_tpu.utils.distributed.initialize`` over loopback, build a
global two-device ``time`` mesh, and run a compiled Parareal solve whose
result each process checks against its local sequential fine solve —
the JAX analog of the reference's ``mpiexec -n 2`` launch
(/root/reference/Makefile:34-35).
"""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    rank = int(sys.argv[1])
    port = sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)

    from pararealml_tpu.utils.distributed import (
        initialize, is_distributed, time_mesh,
    )
    initialize(f"localhost:{port}", num_processes=2, process_id=rank)

    import jax
    assert is_distributed()
    assert jax.process_count() == 2
    assert jax.device_count() == 2
    mesh = time_mesh()
    assert mesh.devices.shape == (2,)

    import numpy as np
    from pararealml_tpu import (
        ConstrainedProblem,
        ContinuousInitialCondition,
        InitialValueProblem,
        LorenzEquation,
    )
    from pararealml_tpu.operators.ode import ODEOperator
    from pararealml_tpu.operators.parareal import PararealOperator

    cp = ConstrainedProblem(LorenzEquation())
    ic = ContinuousInitialCondition(cp, lambda _: np.ones(3))
    ivp = InitialValueProblem(cp, (0.0, 1.0), ic)
    f = ODEOperator("RK4", 0.0025)
    g = ODEOperator("RK4", 0.025)
    parareal = PararealOperator(f, g, 1e-9, devices=jax.devices())
    result = parareal.solve(ivp).discrete_y()
    fine = f.solve(ivp).discrete_y()
    assert result.shape == fine.shape
    assert np.allclose(result, fine, atol=1e-8), (
        np.abs(result - fine).max()
    )
    print(f"rank {rank}: distributed parareal OK", flush=True)
    """
)


@pytest.mark.slow
def test_two_process_distributed_parareal(tmp_path):
    port = str(12000 + os.getpid() % 20000)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    )
    env["PYTHONPATH"] = repo

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), port],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(2)
    ]
    outputs = [proc.communicate(timeout=300)[0] for proc in procs]
    for rank, (proc, output) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, (
            f"rank {rank} failed:\n{output[-3000:]}"
        )
        assert f"rank {rank}: distributed parareal OK" in output
