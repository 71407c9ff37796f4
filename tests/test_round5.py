"""Round-5 surface tests: check_every reaching the distributed Newton
driver, the cycle-aware bench cost model, the gspmd note, and leg-engine
checkpoint resume."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from gpusolve_tpu.config import GridParams, Mode, Stencil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_params(dims=(15, 15, 15), maxiter=3, **kw):
    defaults = dict(
        maxiter=maxiter,
        tol=1e-10,
        grid_dim=dims,
        mode=Mode.NEWTON,
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


def test_newton_spmd_check_every_matches():
    """check_every on the distributed Newton driver batches the inner
    solve's dispatches; histories must match the per-cycle driver (the
    inner stop test runs between batches — at k=2 the cycle counts
    coincide for this contraction rate)."""
    import jax

    from gpusolve_tpu.dist import newton_solve_spmd
    from gpusolve_tpu.dist.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    p = make_params(dims=(31, 31, 31), dtype="float64")
    mesh = make_mesh((2, 1, 1))
    _, hist_1, _ = newton_solve_spmd(p, mesh, cutoff=2)
    _, hist_2, _ = newton_solve_spmd(p, mesh, cutoff=2, check_every=2)
    h1 = np.asarray(hist_1)
    np.testing.assert_allclose(
        np.asarray(hist_2), h1, rtol=1e-10, atol=1e-12 * h1[0]
    )


def run_cli(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import sys; from gpusolve_tpu.cli import main; "
        "sys.exit(main(sys.argv[1:]))"
    )
    return subprocess.run(
        [sys.executable, "-c", code] + args,
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )


def write_conf(tmp_path, mode=2, dim=15, maxiter=2):
    conf = tmp_path / f"r5_m{mode}_d{dim}.conf"
    conf.write_text(
        f"{maxiter}\n1e-5\n{dim}\n{dim}\n{dim}\n{mode}\n2\n2\n0.8\n1.0\n"
        "6 -1 -1 -1 -1 -1 -1\n"
        "0 1 -1 0 0 0 0\n"
        "0 0 0 1 -1 0 0\n"
        "0 0 0 0 0 1 -1\n"
    )
    return str(conf)


def test_cli_newton_check_every(tmp_path):
    """--check-every reaches the distributed Newton driver's inner solves:
    residuals must match the unbatched run's; without a mesh the flag is
    refused."""
    conf = write_conf(tmp_path, mode=2, maxiter=2)
    prog = re.compile(r"newton iter: (\d+) residual: ([\d.e+-]+)")
    mesh = ["--mesh", "2,1,1", "--dtype", "float64"]
    r1 = run_cli([conf, *mesh])
    r2 = run_cli([conf, *mesh, "--check-every", "2"])
    assert r1.returncode == 0 and r2.returncode == 0, r1.stderr + r2.stderr
    res1 = [float(m[1]) for m in prog.findall(r1.stdout)]
    res2 = [float(m[1]) for m in prog.findall(r2.stdout)]
    assert len(res1) == 2 and len(res2) == 2
    np.testing.assert_allclose(res2, res1, rtol=1e-12)
    r3 = run_cli([conf, "--check-every", "2"])
    assert r3.returncode == 1
    assert "--check-every" in r3.stderr


def test_cost_model_scales_with_cycle_type():
    """ADVICE r4: W/F throughput figures must count the work actually
    done — the visit-scaled model, not the V-visit model."""
    sys.path.insert(0, REPO)
    from bench import vcycle_cost_model

    p_v = make_params(dims=(31, 31, 31), mode=Mode.LINEAR)
    nnz_v, bytes_v = vcycle_cost_model(p_v, 4)
    p_w = p_v.replace(cycle_type="W")
    nnz_w, bytes_w = vcycle_cost_model(p_w, 4)
    p_f = p_v.replace(cycle_type="F")
    nnz_f, bytes_f = vcycle_cost_model(p_f, 4)
    assert nnz_w > nnz_f > nnz_v
    assert bytes_w > bytes_f > bytes_v
    # Finest-level work is identical (visited once per cycle in all
    # schedules), so the ratio stays well under the naive 2^l blowup.
    assert nnz_w < 3 * nnz_v


def test_gspmd_prints_demotion_note(tmp_path):
    """VERDICT r4 item 4: no slow engine without a sign — explicit
    --dist-engine gspmd must announce it is the debugging path."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    conf = write_conf(tmp_path, mode=0, dim=15)
    code = (
        "import jax; jax.config.update('jax_platforms','cpu'); "
        "import sys; from gpusolve_tpu.cli import main; "
        "sys.exit(main(sys.argv[1:]))"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, conf, "--mesh", "2,1,1",
         "--dist-engine", "gspmd"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    assert "debugging/fallback" in r.stderr, r.stderr


def test_leg_tail_checkpoint_roundtrip(tmp_path):
    """Checkpoint save/resume on the leg engine: the state must round-trip
    and the resumed history must continue bit-identically."""
    import jax

    from gpusolve_tpu.dist import solve_spmd
    from gpusolve_tpu.dist.mesh import make_mesh
    from gpusolve_tpu.utils.checkpoint import (
        load_state_spmd,
        save_state_spmd,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    p = make_params(
        dims=(63, 63, 63), maxiter=4, mode=Mode.LINEAR, tol=1e-30,
        pre_smoothing=2, post_smoothing=2,
    )
    mesh = make_mesh((2, 1, 1))
    _, h_full, _ = solve_spmd(p, mesh, cutoff=4)
    st, h1, plan = solve_spmd(p.replace(maxiter=2), mesh, cutoff=4)
    path = str(tmp_path / "ckpt_leg.npz")
    save_state_spmd(path, st, plan, p, "spmd", iteration=2, history=h1)
    st2, _, h0, _ = load_state_spmd(path, p, plan, "spmd")
    _, h2, _ = solve_spmd(
        p.replace(maxiter=2), mesh, cutoff=4,
        state=st2, plan=plan, initial_residual=h0[0],
    )
    np.testing.assert_array_equal(
        np.asarray(h1 + h2), np.asarray(h_full)
    )
