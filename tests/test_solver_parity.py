"""Residual-sequence golden tests: framework vs oracle for all three modes.

The per-V-cycle (and per-Newton-step) residual sequence is the reference's own
cross-backend parity metric (SURVEY.md §4: CpuSolver.cpp:28 vs
SyclSolver.cpp:68); here the float64 framework must reproduce the float64
oracle sequence to tight relative tolerance, and float32 must track it to
engineering tolerance.
"""

import numpy as np
import pytest

import oracle as orc
from gpusolve_tpu import build_grid, newton_solve, solve
from gpusolve_tpu.config import GridParams, Mode, Stencil


def make_params(mode, dims=(15, 15, 15), maxiter=6, **kw):
    defaults = dict(
        maxiter=maxiter,
        tol=1e-5,
        grid_dim=dims,
        mode=mode,
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


@pytest.mark.parametrize(
    "mode", [Mode.LINEAR, Mode.NONLINEAR], ids=["linear", "nonlinear"]
)
@pytest.mark.parametrize("dims", [(15, 15, 15), (31, 31, 31)])
def test_solve_residual_sequence(mode, dims):
    p = make_params(mode, dims=dims)
    expected = orc.solve(orc.OracleGrid(p))
    state = build_grid(p)
    _, history = solve(state, p)
    assert len(history) == len(expected)
    np.testing.assert_allclose(history, expected, rtol=1e-8)


def test_newton_residual_sequence():
    p = make_params(Mode.NEWTON, dims=(15, 15, 15), maxiter=5)
    expected = orc.newton_solve(orc.OracleGrid(p))
    state = build_grid(p)
    _, history = newton_solve(state, p)
    assert len(history) == len(expected)
    np.testing.assert_allclose(history, expected, rtol=1e-8)


def test_newton_anisotropic_dims():
    p = make_params(Mode.NEWTON, dims=(15, 7, 31), maxiter=3)
    expected = orc.newton_solve(orc.OracleGrid(p))
    state = build_grid(p)
    _, history = newton_solve(state, p)
    np.testing.assert_allclose(history, expected, rtol=1e-8)


def test_linear_vcycle_contracts():
    # Multigrid sanity: each V-cycle must reduce the residual substantially.
    p = make_params(Mode.LINEAR, dims=(31, 31, 31), maxiter=6)
    state = build_grid(p)
    _, history = solve(state, p)
    factors = [b / a for a, b in zip(history, history[1:])]
    assert all(f < 0.2 for f in factors)


def test_convergence_stops_early():
    # With a loose tolerance the loop must exit before maxiter
    # (stop test reference: src/cpu/CpuSolver.cpp:39).
    p = make_params(Mode.LINEAR, dims=(15, 15, 15), maxiter=20, tol=1e-2)
    state = build_grid(p)
    _, history = solve(state, p)
    assert len(history) - 1 < 20
    assert history[-1] <= history[0] * 1e-2


def test_float32_tracks_oracle():
    # f32 storage (the default dtype) must track the f64 oracle's
    # contraction behavior.
    p64 = make_params(Mode.LINEAR, dims=(31, 31, 31), maxiter=4)
    expected = orc.solve(orc.OracleGrid(p64))
    p32 = p64.replace(dtype="float32")
    state = build_grid(p32)
    _, history = solve(state, p32)
    np.testing.assert_allclose(history, expected, rtol=2e-3)


def test_nonlinear_solution_matches_analytic():
    # The nonlinear problem's exact solution is u=(x-x²)(y-y²)(z-z²)
    # (reference: plotter.py:7-8).  After convergence the discrete solution
    # must approximate it to discretisation error.
    p = make_params(Mode.NONLINEAR, dims=(31, 31, 31), maxiter=10, tol=1e-8)
    state = build_grid(p)
    state, _ = solve(state, p)
    v = np.asarray(state.levels[0].v)
    n = p.grid_dim[0]
    h = p.h
    x = np.arange(1, n + 1) * h
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    exact = (X - X * X) * (Y - Y * Y) * (Z - Z * Z)
    err = np.max(np.abs(v[1 : n + 1, 1 : n + 1, 1 : n + 1] - exact))
    assert err < 5e-4  # O(h²) discretisation error at h=1/32


def test_newton_solution_matches_analytic():
    p = make_params(Mode.NEWTON, dims=(31, 31, 31), maxiter=10, tol=1e-8)
    state = build_grid(p)
    state, _ = newton_solve(state, p)
    u = np.asarray(state.levels[0].newton_v)
    n = p.grid_dim[0]
    h = p.h
    x = np.arange(1, n + 1) * h
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    exact = (X - X * X) * (Y - Y * Y) * (Z - Z * Z)
    err = np.max(np.abs(u[1 : n + 1, 1 : n + 1, 1 : n + 1] - exact))
    assert err < 5e-4


@pytest.mark.parametrize(
    "pre,post,omega,gamma",
    [(1, 2, 0.7, 1.0), (2, 1, 1.0, 0.5), (4, 0, 0.9, 2.0)],
)
def test_parameter_variations_match_oracle(pre, post, omega, gamma):
    # Exercise asymmetric smoothing counts, undamped omega, and non-unit
    # gamma through both linear and FAS paths.
    for mode in (Mode.LINEAR, Mode.NONLINEAR):
        p = make_params(
            mode, dims=(15, 15, 15), maxiter=3,
            pre_smoothing=pre, post_smoothing=post,
            omega=omega, gamma=gamma,
        )
        expected = orc.solve(orc.OracleGrid(p))
        _, history = solve(build_grid(p), p)
        np.testing.assert_allclose(history, expected, rtol=1e-8)
