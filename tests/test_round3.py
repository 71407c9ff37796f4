"""Round-3 surface tests: spmd CLI parity (progress-line format with
``Took Xms``, --save-state/--load-state, --check-every), auto engine
selection, and --explain-backend.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's harness regex (runExperiments.py:46) — spmd progress
# lines must parse under it.
PROGRESS_RE = re.compile(r"iter: (\d+) residual: ([\d\.e-]+) Took (\d+)ms")


def write_conf(tmp_path, mode, dim=15, maxiter=3, stencil=None):
    conf = tmp_path / f"test_m{mode}_i{maxiter}.conf"
    stencil = stencil or (
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 0\n"
        "0 0 0 1 -1 0 0\n"
        "0 0 0 0 0 1 -1\n"
    )
    conf.write_text(
        f"{maxiter}\n1e-5\n{dim}\n{dim}\n{dim}\n{mode}\n3\n3\n0.8\n1.0\n"
        + stencil
    )
    return str(conf)


def run_cli(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    code = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "import sys; from gpusolve_tpu.cli import main; "
        "sys.exit(main(sys.argv[1:]))"
    )
    return subprocess.run(
        [sys.executable, "-c", code, *args],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=300,
    )


def test_spmd_progress_lines_have_took_ms(tmp_path):
    conf = write_conf(tmp_path, mode=0)
    r = run_cli([conf, "--mesh", "2,1,1"])
    assert r.returncode == 0, r.stderr
    assert re.search(r"Inital residual: [\d.e+-]+", r.stdout)
    assert len(PROGRESS_RE.findall(r.stdout)) == 3, r.stdout


def test_mesh_defaults_to_spmd_engine(tmp_path):
    conf = write_conf(tmp_path, mode=0)
    r = run_cli([conf, "--mesh", "2,1,1", "--explain-backend"])
    assert r.returncode == 0, r.stderr
    assert "dist-engine=spmd" in r.stderr, r.stderr


def test_wcycle_mesh_auto_stays_on_spmd(tmp_path):
    """Round 3 added W/F schedules to the explicit spmd engine
    (dist/spmd trace-time schedule recursion), so `--cycle W --mesh ...`
    no longer falls back to the gspmd engine under --dist-engine auto."""
    conf = write_conf(tmp_path, mode=0, maxiter=2)
    r = run_cli([conf, "--mesh", "2,1,1", "--cycle", "W",
                 "--explain-backend"])
    assert r.returncode == 0, r.stderr
    assert "dist-engine=spmd" in r.stderr, r.stderr


def test_spmd_save_and_load_state(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=6)
    conf2 = write_conf(tmp_path, mode=0, maxiter=3)
    ck = str(tmp_path / "sp.npz")
    full = run_cli([conf, "--mesh", "2,1,1"])
    assert full.returncode == 0, full.stderr
    r1 = run_cli([conf2, "--mesh", "2,1,1", "--save-state", ck])
    assert r1.returncode == 0, r1.stderr
    assert f"Saved state to {ck}" in r1.stdout
    r2 = run_cli([conf2, "--mesh", "2,1,1", "--load-state", ck])
    assert r2.returncode == 0, r2.stderr
    assert "Resumed from" in r2.stdout
    # Resume fidelity: 3 + 3 cycles reproduce the 6-cycle run's history.
    res_full = [m[1] for m in PROGRESS_RE.findall(full.stdout)]
    res_resumed = [m[1] for m in PROGRESS_RE.findall(r2.stdout)]
    assert res_resumed == res_full[3:6]


def test_spmd_newton_save_load(tmp_path):
    conf = write_conf(tmp_path, mode=2, maxiter=2)
    ck = str(tmp_path / "spn.npz")
    r1 = run_cli([conf, "--mesh", "2,1,1", "--save-state", ck])
    assert r1.returncode == 0, r1.stderr
    assert f"Saved state to {ck}" in r1.stdout
    assert re.search(
        r"newton iter: \d+ residual: [\d\.e-]+ Took \d+ms", r1.stdout
    )
    r2 = run_cli([conf, "--mesh", "2,1,1", "--load-state", ck])
    assert r2.returncode == 0, r2.stderr
    assert "Resumed from" in r2.stdout


def test_spmd_load_state_engine_mismatch_errors(tmp_path):
    """A checkpoint written by one engine must not silently load into
    another (never-silently-ignore, VERDICT item 3)."""
    conf = write_conf(tmp_path, mode=0, maxiter=2)
    ck = str(tmp_path / "sp.npz")
    r1 = run_cli([conf, "--mesh", "2,1,1", "--save-state", ck])
    assert r1.returncode == 0, r1.stderr
    r2 = run_cli([conf, "--mesh", "1,2,1", "--load-state", ck])
    assert r2.returncode == 1
    assert "different problem/mesh/engine" in r2.stderr


def test_spmd_check_every_preserves_history(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=4)
    r1 = run_cli([conf, "--mesh", "2,1,1"])
    r2 = run_cli([conf, "--mesh", "2,1,1", "--check-every", "2"])
    assert r1.returncode == 0 and r2.returncode == 0
    h1 = [m[1] for m in PROGRESS_RE.findall(r1.stdout)]
    h2 = [m[1] for m in PROGRESS_RE.findall(r2.stdout)]
    assert h1 == h2 and len(h1) == 4


def test_corner_tap_stencil_gating_note(tmp_path):
    """A corner-tap stencil (legal per the config format) takes the spmd
    engine's fully assembled halo path; its history must match the
    single-device solve's."""
    stencil = (
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 1\n"   # last tap offset (1, 1, 0): corner tap
        "0 0 0 1 -1 0 1\n"
        "0 0 0 0 0 1 0\n"
    )
    conf = write_conf(tmp_path, mode=0, stencil=stencil, maxiter=2)
    r = run_cli([conf, "--mesh", "2,2,1", "--explain-backend"])
    one = run_cli([conf])
    assert r.returncode == 0 and one.returncode == 0, r.stderr + one.stderr
    assert "dist-engine=spmd" in r.stderr, r.stderr
    got = [float(m[1]) for m in PROGRESS_RE.findall(r.stdout)]
    want = [float(m[1]) for m in PROGRESS_RE.findall(one.stdout)]
    assert len(got) == 2
    assert got == pytest.approx(want, rel=1e-4)


def test_explain_backend_single_device(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=2)
    r = run_cli([conf, "--explain-backend"])
    assert r.returncode == 0, r.stderr
    assert "backend: single device" in r.stderr


def test_float64_gating_note(tmp_path, capsys):
    """float64 runs the same device path as float32: no gating note."""
    from gpusolve_tpu.cli import main

    conf = write_conf(tmp_path, mode=0, maxiter=2)
    assert main([conf, "--dtype", "float64", "--explain-backend"]) == 0
    err = capsys.readouterr().err
    assert "backend: single device: XLA ops" in err
    assert "note:" not in err
