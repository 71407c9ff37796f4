"""Leg engine (dist/spmd.py) on 2 and 4 virtual devices against the
single-device solver, across mesh shapes — x splits, y splits, both, and a
z mesh axis folded into y — and all three modes, in float64.

Also pins the engine's shard-local transfers (stride-2 slice forms) to the
single-device ops on whole-grid blocks.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpusolve_tpu import build_grid, newton_solve, solve
from gpusolve_tpu.config import GridParams, Mode, Stencil
from gpusolve_tpu.dist import make_mesh
from gpusolve_tpu.dist import spmd
from gpusolve_tpu.ops import xla

MESHES = [(2, 1, 1), (1, 2, 1), (4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2)]


def _params(mode, grid=(31, 31, 31), maxiter=2, **kw):
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
        print_progress=False,
        dtype="float64",
        **kw,
    )


@pytest.mark.parametrize(
    "mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s))
)
@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON],
    ids=["linear", "nonlinear", "newton"],
)
def test_leg_engine_matches_single_device(mode, mesh_shape):
    p = _params(mode)
    if mode == Mode.NEWTON:
        _, ref = newton_solve(build_grid(p), p)
        _, hist, plan = spmd.newton_solve_spmd(
            p, make_mesh(mesh_shape), cutoff=2
        )
    else:
        _, ref = solve(build_grid(p), p)
        _, hist, plan = spmd.solve_spmd(p, make_mesh(mesh_shape), cutoff=2)
    assert plan.n_dist >= 2
    np.testing.assert_allclose(hist, ref, rtol=1e-10)


def test_z_mesh_axis_folds_into_y():
    """A (2,2,2) device mesh folds to a (2,4,1) data decomposition."""
    p = _params(Mode.LINEAR, grid=(31, 31, 63))
    plan = spmd.SpmdPlan(p, (2, 2, 2), cutoff=2)
    assert plan.mesh_shape == (2, 4, 1)
    assert plan.names == ("x", ("y", "z"), "z")
    _, ref = solve(build_grid(p), p)
    _, hist, _ = spmd.solve_spmd(p, make_mesh((2, 2, 2)), cutoff=2)
    np.testing.assert_allclose(hist, ref, rtol=1e-10)


@pytest.mark.parametrize("dims", [(15, 15, 15), (31, 15, 7), (7, 31, 15)])
def test_local_restriction_matches_single_device_op(dims):
    """On one shard the ghost-extended block is the whole padded grid, so
    the separable slice restriction must equal the 27-point op."""
    rng = np.random.default_rng(0)
    p = _params(Mode.LINEAR, grid=dims)
    d0, d1 = p.level_dims()[:2]
    fine = np.zeros(tuple(n + 2 for n in d0))
    fine[1:-1, 1:-1, 1:-1] = rng.standard_normal(d0)
    want = xla.restrict_full_weighting(
        fine, d0, d1, tuple(n + 2 for n in d1)
    )
    # Block layout: local cell j <-> global padded index j, so the
    # ghost-extended block starts one cell before the padded origin; the
    # coarse block holds the coarse padded indices [0, n1 + 2).
    cb = tuple(n + 2 for n in d1)
    asm = np.pad(fine, [(1, 2 * c - n - 1) for c, n in zip(cb, d0)])
    got = np.asarray(spmd._restrict_local(jnp.asarray(asm), cb))
    inner = (slice(1, -1),) * 3
    np.testing.assert_allclose(
        got[inner], np.asarray(want)[inner], rtol=1e-13
    )


@pytest.mark.parametrize("dims", [(15, 15, 15), (31, 15, 7), (7, 31, 15)])
def test_local_prolongation_matches_single_device_op(dims):
    """The interleaved slice prolongation equals the 4-pass trilinear op on
    the whole grid (one shard, coarse block assembled with one ghost)."""
    rng = np.random.default_rng(1)
    p = _params(Mode.LINEAR, grid=dims)
    d0, d1 = p.level_dims()[:2]
    coarse = np.zeros(tuple(n + 2 for n in d1))
    coarse[1:-1, 1:-1, 1:-1] = rng.standard_normal(d1)
    want = np.asarray(
        xla.interpolate(coarse, d1, d0, tuple(n + 2 for n in d0))
    )
    fb = tuple(n + 2 for n in d0)  # fine block = the padded fine grid
    asm = np.pad(coarse, [(1, 1)] * 3)  # ghost below, room above
    got = np.asarray(spmd._prolong_local(jnp.asarray(asm), fb))
    inner = (slice(1, -1),) * 3
    np.testing.assert_allclose(got[inner], want[inner], rtol=1e-13)
