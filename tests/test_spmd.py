"""Explicit-halo SPMD engine tests (shard_map + ppermute) on the 8-device
virtual CPU mesh: residual sequences must equal the single-device solver."""

import numpy as np
import pytest

import jax

from gpusolve_tpu import build_grid, solve
from gpusolve_tpu.config import GridParams, Mode, Stencil
from gpusolve_tpu.dist import make_mesh
from gpusolve_tpu.dist.spmd import SpmdPlan, solve_spmd


def make_params(dims=(31, 31, 31), maxiter=4, **kw):
    defaults = dict(
        maxiter=maxiter,
        tol=1e-12,
        grid_dim=dims,
        mode=Mode.LINEAR,
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        dtype="float64",
        print_progress=False,
    )
    defaults.update(kw)
    return GridParams(**defaults)


def test_plan_shapes():
    p = make_params(dims=(31, 31, 31))
    plan = SpmdPlan(p, (2, 2, 1), cutoff=4)
    # 31,15,7,3,1 — distributed while interior//2 >= 4: 31 (15), 15 (7) -> 2
    assert plan.n_dist == 2
    # mesh-aware alloc halves exactly between distributed levels
    for a in range(3):
        assert plan.alloc[0][a] == 2 * plan.alloc[1][a]
        assert plan.alloc[0][a] % 2 == 0
        assert plan.alloc[0][a] >= 33
        assert plan.alloc[1][a] >= 17
        assert plan.block[0][a] == plan.alloc[0][a] // plan.mesh_shape[a]


def test_plan_folds_z_mesh_into_y():
    """The engine never splits the z data axis: a z mesh axis folds into
    the y data decomposition (collectives ride the flattened ('y','z')
    device-axis pair) — SpmdPlan docstring."""
    p = make_params(dims=(63, 63, 63))
    plan = SpmdPlan(p, (2, 2, 2), cutoff=4)
    assert plan.device_mesh == (2, 2, 2)
    assert plan.mesh_shape == (2, 4, 1)
    assert plan.names == ("x", ("y", "z"), "z")
    for l in range(plan.n_dist):
        assert plan.block[l][2] == plan.alloc[l][2]  # z unsplit
        assert plan.block[l][1] == plan.alloc[l][1] // 4


@pytest.mark.parametrize("dims", [(31, 31, 31), (15, 31, 15)])
def test_spmd_matches_single_device(dims):
    p = make_params(dims=dims)
    _, ref_history = solve(build_grid(p), p)

    mesh = make_mesh((2, 2, 2))
    _, history, _ = solve_spmd(p, mesh, cutoff=3)
    assert len(history) == len(ref_history)
    np.testing.assert_allclose(history, ref_history, rtol=1e-10)


def test_spmd_anisotropic_mesh():
    p = make_params(dims=(31, 31, 31), maxiter=3)
    _, ref_history = solve(build_grid(p), p)
    mesh = make_mesh((4, 2, 1))
    _, history, _ = solve_spmd(p, mesh, cutoff=3)
    np.testing.assert_allclose(history, ref_history, rtol=1e-10)


def test_spmd_fas_matches_single_device():
    """FAS (nonlinear) on the explicit halo engine: residual sequences must
    equal the single-device solver (VERDICT r1 item 2)."""
    p = make_params(dims=(31, 31, 31), maxiter=3, mode=Mode.NONLINEAR)
    _, ref_history = solve(build_grid(p), p)
    mesh = make_mesh((2, 2, 2))
    _, history, _ = solve_spmd(p, mesh, cutoff=3)
    np.testing.assert_allclose(history, ref_history, rtol=1e-10)


def test_spmd_newton_matches_single_device():
    """Outer Newton on the explicit halo engine vs the single-device Newton
    driver (reference src/cpu/NewtonSolver.cpp parity)."""
    from gpusolve_tpu import newton_solve
    from gpusolve_tpu.dist.spmd import newton_solve_spmd

    p = make_params(dims=(31, 31, 31), maxiter=3, mode=Mode.NEWTON)
    _, ref_history = newton_solve(build_grid(p), p)
    mesh = make_mesh((2, 2, 2))
    _, history, _ = newton_solve_spmd(p, mesh, cutoff=3)
    np.testing.assert_allclose(history, ref_history, rtol=1e-10)


def test_spmd_gather_solution_validates():
    """gather_solution assembles the sharded finest-level field for
    dump/--validate (VERDICT r1 item 2)."""
    from gpusolve_tpu.dist.spmd import gather_solution
    from gpusolve_tpu.utils.dump import compare_analytic

    p = make_params(dims=(31, 31, 31), maxiter=12, mode=Mode.NONLINEAR)
    mesh = make_mesh((2, 2, 2))
    state, _, plan = solve_spmd(p, mesh, cutoff=3)
    sol = gather_solution(state, plan, mesh)
    assert sol.shape == (33, 33, 33)
    assert compare_analytic(sol, p.h) < 5e-3
