"""Multi-host scaffolding smoke tests (SURVEY.md §5 distributed row).

The plumbing is exercised two ways: in-process (single-process degrade)
and, where the CPU backend's gloo collectives are
compiled in, a genuine 2-process ``jax.distributed.initialize`` run driven
through subprocesses, each solving the same sharded problem and agreeing on
the residual history.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest

from gpusolve_tpu.dist import multihost


def test_initialize_single_process_is_noop():
    # No coordinator env/args → plain single-process run, returns False and
    # leaves the runtime untouched.
    assert multihost.initialize() is False
    assert jax.process_count() == 1
    assert multihost.is_multiprocess() is False


_WORKER = textwrap.dedent(
    """
    import os, sys, json
    sys.path.insert(0, os.environ["GS_REPO"])
    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception as e:
        print(json.dumps({"skip": f"no gloo: {e}"}))
        raise SystemExit(0)
    from gpusolve_tpu.dist import make_mesh, multihost
    ok = multihost.initialize()  # env-driven: JAX_COORDINATOR_ADDRESS etc.
    assert ok, "initialize() returned False despite coordinator env"
    assert jax.process_count() == 2, jax.process_count()
    mesh = make_mesh()
    assert mesh.devices.size == jax.device_count()

    from gpusolve_tpu.config import GridParams, Mode, Stencil
    from gpusolve_tpu.dist import solve_spmd
    params = GridParams(
        maxiter=2, tol=1e-30, grid_dim=(15, 15, 15), mode=Mode.LINEAR,
        pre_smoothing=2, post_smoothing=2, omega=0.8, gamma=1.0,
        stencil=Stencil.poisson_7pt(), print_progress=False,
    )
    _, history, _ = solve_spmd(params, mesh, cutoff=2)
    print(json.dumps({"pid": jax.process_index(), "history": history}))
    """
)


def test_two_process_cpu_smoke(tmp_path):
    """Spawn two real processes joined by jax.distributed over localhost."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = 12357
    env_base = {
        **os.environ,
        "GS_REPO": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": "2",
        # Two local devices per process → 4 global devices.
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "JAX_PLATFORMS": "cpu",
    }
    procs = []
    for pid in range(2):
        env = {**env_base, "JAX_PROCESS_ID": str(pid)}
        procs.append(
            subprocess.Popen(
                [sys.executable, "-u", str(script)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("multi-process CPU run timed out (no gloo runtime?)")
        outs.append((p.returncode, out, err))
    payloads = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        line = out.strip().splitlines()[-1]
        payload = json.loads(line)
        if "skip" in payload:
            pytest.skip(payload["skip"])
        payloads.append(payload)
    # Both processes must see the identical global residual history.
    assert payloads[0]["history"] == payloads[1]["history"]
    assert len(payloads[0]["history"]) == 3  # initial + 2 cycles
