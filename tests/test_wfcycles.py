"""W- and F-cycle schedule tests (beyond-reference capability).

The reference only has V-cycles (src/cpu/CpuSolver.cpp:85-139); the
framework adds the standard gamma-cycle W (recurse twice per level) and F
(recurse F-then-V) schedules via ``GridParams.cycle_type``.  Parity chain:
the float64 XLA solver must match the float64 oracle's recursion exactly;
the explicit spmd engine must match the single-device solver; and
per-cycle contraction must not degrade vs V (W/F visit coarse levels more,
so they converge at least as fast per outer cycle on this SPD problem).
"""

import numpy as np
import pytest

import oracle as orc
from gpusolve_tpu import build_grid, newton_solve, solve
from gpusolve_tpu.config import GridParams, Mode, Stencil


def make_params(mode, cycle, dims=(15, 15, 15), maxiter=4, **kw):
    defaults = dict(
        maxiter=maxiter,
        tol=1e-10,
        grid_dim=dims,
        mode=mode,
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        dtype="float64",
        print_progress=False,
        cycle_type=cycle,
    )
    defaults.update(kw)
    return GridParams(**defaults)


@pytest.mark.parametrize("cycle", ["W", "F"])
@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NONLINEAR], ids=["linear", "nonlinear"]
)
def test_wf_residual_sequence_vs_oracle(mode, cycle):
    p = make_params(mode, cycle)
    expected = orc.solve(orc.OracleGrid(p))
    state = build_grid(p)
    _, history = solve(state, p)
    assert len(history) == len(expected)
    np.testing.assert_allclose(history, expected, rtol=1e-8)


@pytest.mark.parametrize("cycle", ["W", "F"])
def test_wf_newton_vs_oracle(cycle):
    p = make_params(Mode.NEWTON, cycle, maxiter=3)
    expected = orc.newton_solve(orc.OracleGrid(p))
    state = build_grid(p)
    _, history = newton_solve(state, p)
    np.testing.assert_allclose(history, expected, rtol=1e-8)


@pytest.mark.parametrize("cycle", ["W", "F"])
def test_wf_contraction_not_worse_than_v(cycle):
    # Per-cycle residual reduction of W/F must beat (or match) V on the
    # linear Poisson problem.
    histories = {}
    for c in ("V", cycle):
        p = make_params(Mode.LINEAR, c, dims=(31, 31, 31), maxiter=3)
        _, h = solve(build_grid(p), p)
        histories[c] = h
    assert histories[cycle][-1] <= histories["V"][-1] * 1.01


@pytest.mark.parametrize("dims", [(15, 7, 31), (31, 15, 15)])
@pytest.mark.parametrize("cycle", ["V", "W", "F"])
@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON],
    ids=["linear", "nonlinear", "newton"],
)
def test_cycle_mode_matrix_vs_oracle(mode, cycle, dims):
    """Every schedule in every mode on non-cubic grids, against the f64
    oracle's recursion."""
    p = make_params(mode, cycle, dims=dims, maxiter=2)
    if mode == Mode.NEWTON:
        expected = orc.newton_solve(orc.OracleGrid(p))
        _, history = newton_solve(build_grid(p), p)
    else:
        expected = orc.solve(orc.OracleGrid(p))
        _, history = solve(build_grid(p), p)
    assert len(history) == len(expected) == 3
    np.testing.assert_allclose(history, expected, rtol=1e-8)


def test_cycle_type_validation():
    with pytest.raises(ValueError):
        make_params(Mode.LINEAR, "X")


@pytest.mark.parametrize("cycle", ["W", "F"])
def test_wf_on_spmd_engine_matches_gspmd(cycle):
    """Round-3 item 10: W/F schedules on the explicit spmd engine (the
    per-leg trace-time recursion mirrors solver/vcycle.py's) — f64
    2-shard histories must match the single-device solver."""
    from gpusolve_tpu.dist import make_mesh
    from gpusolve_tpu.dist.spmd import solve_spmd

    p = make_params(
        Mode.NONLINEAR, cycle, dims=(31, 31, 31), maxiter=3,
    )
    _, ref = solve(build_grid(p), p)
    _, hist, _ = solve_spmd(p, make_mesh((2, 2, 2)), cutoff=2)
    np.testing.assert_allclose(hist, ref, rtol=1e-11)
