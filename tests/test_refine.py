"""Mixed-precision iterative refinement (solver/refine.py).

The claim under test: with f32 inner V-cycles and only the O(N) outer defect
in f64, the residual reaches f64 territory (far below the ~1e-6-relative f32
floor) and the solution matches a pure-f64 solve.  Verified for all three
modes against the float64 oracle (tests/oracle.py), and over the CLI flag.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import oracle as orc
from gpusolve_tpu.config import GridParams, Mode, Stencil
from gpusolve_tpu.solver.refine import solve_refine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "import sys; from gpusolve_tpu.cli import main; "
        "sys.exit(main(sys.argv[1:]))"
    )
    return subprocess.run(
        [sys.executable, "-c", code, *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
    )


def make_params(mode, dims=(31, 31, 31), **kw):
    defaults = dict(
        maxiter=12,
        tol=1e-11,
        grid_dim=dims,
        mode=mode,
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        dtype="float32",
        print_progress=False,
    )
    defaults.update(kw)
    return GridParams(**defaults)


def oracle_solution(p, maxiter=60, tol=1e-13):
    """Drive the float64 oracle to (near) machine-precision residual and
    return the finest-level solution field."""
    po = p.replace(maxiter=maxiter, tol=tol, dtype="float64")
    g = orc.OracleGrid(po)
    if po.mode == Mode.NEWTON:
        orc.newton_solve(g)
        return g.levels[0].newton_v
    orc.solve(g)
    return g.levels[0].v


@pytest.mark.parametrize(
    "mode",
    [Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON],
    ids=["linear", "nonlinear", "newton"],
)
def test_refine_reaches_f64_accuracy(mode):
    p = make_params(mode)
    u, hist = solve_refine(p)
    # Residual below anything a pure-f32 solve can reach (~1e-6 relative).
    assert hist[-1] <= hist[0] * 1e-11
    # Outer contraction: each refinement step gains ~inner_tol.
    assert hist[1] <= hist[0] * 1e-2

    # Solution parity with a converged pure-f64 solve.  For the nonlinear
    # modes the equation has one solution, so FAS/Newton/refine all land on
    # it; LINEAR compares against the oracle's linear MG fixed point.
    u_ref = oracle_solution(p)
    nx, ny, nz = p.grid_dim
    got = np.asarray(u)[: nx + 2, : ny + 2, : nz + 2]
    scale = np.max(np.abs(u_ref))
    assert np.max(np.abs(got - u_ref)) <= 1e-8 * scale


def test_refine_nonlinear_matches_newton_refine():
    """NONLINEAR under refinement uses the Newton outer (module docstring);
    both nonlinear modes must produce the identical iteration."""
    u1, h1 = solve_refine(make_params(Mode.NONLINEAR))
    u2, h2 = solve_refine(make_params(Mode.NEWTON))
    np.testing.assert_allclose(h1, h2, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))


def test_refine_rejects_f64_inner():
    p = make_params(Mode.LINEAR, dtype="float64")
    with pytest.raises(ValueError, match="float32"):
        solve_refine(p)


def test_refine_inner_tol_sets_contraction():
    """A looser inner tolerance gives a visibly weaker per-outer gain."""
    # tol tiny (not 0: the stop test is the reference's ``initial/(1/tol)``
    # expression, src/cpu/CpuSolver.cpp:39, which needs tol > 0).
    p = make_params(Mode.LINEAR, maxiter=3, tol=1e-30)
    _, tight = solve_refine(p, inner_tol=1e-4)
    _, loose = solve_refine(p, inner_tol=5e-2)
    assert tight[1] < loose[1]
    assert loose[1] <= loose[0] * 0.2  # still contracting


@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NEWTON], ids=["linear", "newton"]
)
def test_refine_sharded_matches_oracle(mode):
    """Distributed refinement (GSPMD inner solves over a 2×2×2 mesh, f64
    outer arrays on the finest level's sharding) reaches the same f64
    accuracy as the single-device path."""
    from gpusolve_tpu.dist import level_shardings, make_mesh

    p = make_params(mode)
    mesh = make_mesh((2, 2, 2))
    shardings = level_shardings(p.replace(dtype="float32"), mesh)
    u, hist = solve_refine(p, shardings=shardings)
    assert hist[-1] <= hist[0] * 1e-11
    u_ref = oracle_solution(p)
    nx, ny, nz = p.grid_dim
    got = np.asarray(u)[: nx + 2, : ny + 2, : nz + 2]
    scale = np.max(np.abs(u_ref))
    assert np.max(np.abs(got - u_ref)) <= 1e-8 * scale


def test_cli_refine(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(
        "8\n1e-10\n31 31 31\n2\n3 3\n0.8\n1.0\n"
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 0\n0 0 0 1 -1 0 0\n0 0 0 0 0 1 -1\n"
    )
    out = run_cli([str(conf), "--refine", "--validate"])
    assert out.returncode == 0, out.stderr
    assert "Inital newton residual:" in out.stdout
    lines = [l for l in out.stdout.splitlines() if l.startswith("newton iter")]
    assert lines, out.stdout
    last = float(lines[-1].split("residual:")[1].split()[0])
    assert last <= 1e-8
    # The refined solution validates against the analytic solution.
    err_line = [
        l for l in out.stdout.splitlines() if "max-abs error" in l
    ]
    assert err_line and float(err_line[0].split(":")[1]) < 1e-3


def test_cli_refine_incompatible_flags(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(
        "2\n1e-5\n15 15 15\n0\n3 3\n0.8\n1.0\n"
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 0\n0 0 0 1 -1 0 0\n0 0 0 0 0 1 -1\n"
    )
    out = run_cli([str(conf), "--refine", "--dtype", "float64"], timeout=120)
    assert out.returncode == 1
    assert "--refine is incompatible" in out.stderr


@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NONLINEAR], ids=["linear", "nonlinear"]
)
def test_refine_spmd_engine_matches_oracle(mode):
    """Distributed refinement on the explicit spmd engine: inner f32
    solves on the leg engine, f64 outer defect sharded on the finest
    spec — same accuracy contract as the gspmd variant, here on a folded
    (2,2,2) virtual mesh."""
    from gpusolve_tpu.dist import make_mesh
    from gpusolve_tpu.solver.refine import solve_refine_spmd

    p = make_params(mode)
    mesh = make_mesh((2, 2, 2))
    u, hist = solve_refine_spmd(p, mesh, cutoff=2)
    assert hist[-1] <= hist[0] * 1e-11
    u_ref = oracle_solution(p)
    nx, ny, nz = p.grid_dim
    got = np.asarray(u)[: nx + 2, : ny + 2, : nz + 2]
    scale = np.max(np.abs(u_ref))
    assert np.max(np.abs(got - u_ref)) <= 1e-8 * scale


def test_cli_refine_spmd_engine(tmp_path):
    conf = tmp_path / "r.conf"
    conf.write_text(
        "8\n1e-11\n15\n15\n15\n0\n3\n3\n0.8\n1.0\n"
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 0\n"
        "0 0 0 1 -1 0 0\n"
        "0 0 0 0 0 1 -1\n"
    )
    r = run_cli([
        str(conf), "--refine", "--mesh", "2,1,1",
        "--dist-engine", "spmd", "--explain-backend",
    ])
    assert r.returncode == 0, r.stderr
    assert "Inital residual" in r.stdout
