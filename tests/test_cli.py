"""CLI surface tests: output-line parity with the reference
(src/main.cpp:28,44-51; progress format regex from runExperiments.py:46)
and dump/plot tooling (Vector3::dump / plotter.py parity)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from gpusolve_tpu.utils.dump import (
    analytic_solution,
    compare_analytic,
    dump_field,
    load_dump,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_conf(tmp_path, mode, dim=15, maxiter=3):
    conf = tmp_path / "test.conf"
    conf.write_text(
        f"{maxiter}\n1e-5\n{dim}\n{dim}\n{dim}\n{mode}\n3\n3\n0.8\n1.0\n"
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 0\n"
        "0 0 0 1 -1 0 0\n"
        "0 0 0 0 0 1 -1\n"
    )
    return str(conf)


def run_cli(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
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


def test_cli_linear_progress_format(tmp_path):
    conf = write_conf(tmp_path, mode=0)
    r = run_cli([conf])
    assert r.returncode == 0, r.stderr
    assert f"Using config file {conf}" in r.stdout
    assert "Solving linear problem" in r.stdout
    assert re.search(r"Inital residual: [\d.e+-]+", r.stdout)
    # The exact pattern the reference experiment harness parses
    # (runExperiments.py:46).
    matches = re.findall(
        r"iter: (\d+) residual: ([\d\.e-]+) Took (\d+)ms", r.stdout
    )
    assert len(matches) == 3


def test_cli_newton_progress_format(tmp_path):
    conf = write_conf(tmp_path, mode=2, maxiter=2)
    r = run_cli([conf])
    assert r.returncode == 0, r.stderr
    assert "Solving newton problem" in r.stdout
    assert re.search(r"Inital newton residual: [\d.e+-]+", r.stdout)
    assert re.search(
        r"newton iter: \d+ residual: [\d\.e-]+ Took \d+ms", r.stdout
    )


def test_cli_missing_file():
    r = run_cli(["/nonexistent/path.conf"])
    assert r.returncode == 1
    assert "does not exist or is not a file" in r.stderr


def test_cli_dump_validate(tmp_path):
    conf = write_conf(tmp_path, mode=1, maxiter=8)
    dump_path = str(tmp_path / "v.txt")
    r = run_cli([conf, "--dump", dump_path, "--validate", "--quiet"])
    assert r.returncode == 0, r.stderr
    m = re.search(r"max-abs error vs analytic solution: ([\d.e+-]+)", r.stdout)
    assert m, r.stdout
    assert float(m.group(1)) < 5e-3  # 15^3 grid, coarse h
    # Dump round-trips and is plotter.py-compatible.
    mesh = load_dump(dump_path)
    assert mesh.shape == (17, 17, 17)
    assert compare_analytic(mesh, 1.0 / 16.0) < 5e-3


def test_plotter_script_writes_figure(tmp_path):
    """scripts/plotter.py renders the mid-plane overlay figure from a dump
    (the counterpart of the reference's plotter.py:28-48)."""
    conf = write_conf(tmp_path, mode=1, maxiter=8)
    dump_path = str(tmp_path / "v.txt")
    r = run_cli([conf, "--dump", dump_path, "--quiet"])
    assert r.returncode == 0, r.stderr
    out_png = str(tmp_path / "v.png")
    r2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "plotter.py"),
         dump_path, "-o", out_png],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert r2.returncode == 0, r2.stderr
    assert os.path.exists(out_png) and os.path.getsize(out_png) > 1000
    m = re.search(r"max-abs mid-plane error ([\d.e+-]+)", r2.stdout)
    assert m and float(m.group(1)) < 5e-3


def test_dump_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 4, 3))
    path = str(tmp_path / "f.txt")
    dump_field(a, path)
    b = load_dump(path)
    np.testing.assert_allclose(a, b, rtol=1e-15)
    # Header format matches Vector3::dump (src/cpu/Vector3.cpp:63-64).
    assert open(path).readline() == "5 4 3\n"


def test_analytic_solution_zero_on_boundary():
    u = analytic_solution((17, 17, 17), 1.0 / 16.0)
    assert np.allclose(u[0], 0) and np.allclose(u[-1], 0)


def test_checkpoint_roundtrip(tmp_path):
    # Solving N+M cycles straight must equal solving N, checkpointing,
    # resuming, and solving M (the V-cycle is a stationary iteration).
    import jax

    from gpusolve_tpu import build_grid, solve
    from gpusolve_tpu.config import GridParams, Mode, Stencil
    from gpusolve_tpu.utils.checkpoint import load_state, save_state

    p8 = GridParams(
        maxiter=6, tol=1e-12, grid_dim=(15, 15, 15), mode=Mode.LINEAR,
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        stencil=Stencil.poisson_7pt(), dtype="float64",
        print_progress=False,
    )
    _, straight = solve(build_grid(p8), p8)

    p3 = p8.replace(maxiter=3)
    state, hist1 = solve(build_grid(p3), p3)
    ck = str(tmp_path / "state.npz")
    save_state(ck, state, p3, iteration=3, history=hist1)
    state2, it, hist_saved = load_state(ck, p3)
    assert it == 3
    _, hist2 = solve(state2, p3)
    combined = hist1 + hist2[1:]
    np.testing.assert_allclose(combined, straight, rtol=1e-12)


def test_checkpoint_config_mismatch(tmp_path):
    from gpusolve_tpu import build_grid
    from gpusolve_tpu.config import GridParams, Mode, Stencil
    from gpusolve_tpu.utils.checkpoint import load_state, save_state

    p = GridParams(
        maxiter=1, tol=1e-5, grid_dim=(15, 15, 15), mode=Mode.LINEAR,
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        stencil=Stencil.poisson_7pt(), dtype="float64",
        print_progress=False,
    )
    ck = str(tmp_path / "s.npz")
    save_state(ck, build_grid(p), p)
    with pytest.raises(ValueError, match="different problem"):
        load_state(ck, p.replace(grid_dim=(31, 31, 31)))


def test_cli_save_load_state(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=2)
    ck = str(tmp_path / "ck.npz")
    r = run_cli([conf, "--quiet", "--save-state", ck])
    assert r.returncode == 0, r.stderr
    assert "Saved state to" in r.stdout
    r2 = run_cli([conf, "--quiet", "--load-state", ck])
    assert r2.returncode == 0, r2.stderr
    assert "Resumed from" in r2.stdout


def test_cli_devices_flag(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=1, dim=7)
    r = run_cli([conf, "--quiet", "--devices"])
    assert r.returncode == 0, r.stderr
    assert "Device [0]:" in r.stdout


def test_cli_profile_flag(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=1, dim=7)
    trace_dir = str(tmp_path / "trace")
    r = run_cli([conf, "--quiet", "--profile", trace_dir])
    assert r.returncode == 0, r.stderr
    assert "Wrote profiler trace" in r.stdout
    import os

    found = []
    for root, _, files in os.walk(trace_dir):
        found.extend(files)
    assert found, "profiler trace directory is empty"


def test_cli_cycle_flag(tmp_path):
    conf = write_conf(tmp_path, mode=0, maxiter=3, dim=15)
    rv = run_cli([conf, "--cycle", "V"])
    rw = run_cli([conf, "--cycle", "W"])
    assert rv.returncode == 0 and rw.returncode == 0
    import re

    def last_res(out):
        vals = re.findall(r"residual: ([0-9.eE+-]+)", out)
        return float(vals[-1])

    # W converges at least as fast per cycle as V on this SPD problem.
    assert last_res(rw.stdout) <= last_res(rv.stdout) * 1.01
    # rejected combinations error out cleanly
    rbad = run_cli([conf, "--cycle", "W", "--backend", "cpu-native"])
    assert rbad.returncode == 1
