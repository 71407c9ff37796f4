"""Distributed parity in float64.

The leg engine runs 2-shard f64 solves whose histories must match the
single-device f64 solver to ~1e-12 — reassociation noise of the
separable shard-local transfers only."""

import numpy as np
import pytest

from gpusolve_tpu import build_grid, solve
from gpusolve_tpu.config import GridParams, Mode, Stencil
from gpusolve_tpu.dist import make_mesh
from gpusolve_tpu.dist.spmd import newton_solve_spmd, solve_spmd
from gpusolve_tpu.solver.newton import newton_solve


def _params(mode, grid=(63, 31, 127), maxiter=3):
    return GridParams(
        maxiter=maxiter,
        tol=1e-30,
        grid_dim=grid,
        mode=mode,
        pre_smoothing=2,
        post_smoothing=2,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        dtype="float64",
        print_progress=False,
    )


@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NONLINEAR], ids=["linear", "nonlinear"]
)
def test_leg_engine_f64_two_shard(mode):
    """2-shard leg engine in f64."""
    p = _params(mode)
    _, ref = solve(build_grid(p), p)
    mesh = make_mesh((2, 1, 1))
    _, hist, plan = solve_spmd(p, mesh, cutoff=2)
    assert plan.n_dist >= 2, "the run must keep distributed levels"
    np.testing.assert_allclose(hist, ref, rtol=1e-12)


def test_leg_engine_f64_newton():
    p = _params(Mode.NEWTON, maxiter=2)
    _, ref = newton_solve(build_grid(p), p)
    _, hist, _ = newton_solve_spmd(p, make_mesh((2, 1, 1)), cutoff=2)
    np.testing.assert_allclose(hist, ref, rtol=1e-11)
