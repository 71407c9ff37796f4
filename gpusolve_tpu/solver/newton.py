"""Outer Newton iteration for ``-Δu + γ·u·e^u = f`` (mode 2).

Reference: src/cpu/NewtonSolver.cpp (GPU mirror src/sycl/NewtonSolver.cpp).
Each outer step solves the Jacobian system ``J(ũ)·e = F(ũ)`` with a short
inner linear multigrid solve (maxiter=10, tol=0.1) where the smoother and
residual use the frozen linearisation point ``ũ`` (= newton_v), then updates
``ũ += e``.

Behavioral quirks reproduced exactly (see SURVEY.md §7):
  * ``findError`` restricts newton_v only to levels 1..numLevels-2 — never the
    coarsest (src/cpu/NewtonSolver.cpp:88-92), so the coarsest level's Newton
    terms use a stale/zero linearisation point.
  * compF is (re)invoked at the top of each outer iteration and again for the
    convergence measurement (src/cpu/NewtonSolver.cpp:21,26).
  * The inner solve silences progress printing and restores maxiter/tol after
    (src/cpu/NewtonSolver.cpp:94-104) — here that's just a params.replace,
    and thanks to trace_params() it reuses the same compiled V-cycle.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from gpusolve_tpu.config import GridParams, Mode
from gpusolve_tpu.grid import GridState
from gpusolve_tpu.ops import xla
from gpusolve_tpu.solver import vcycle as vc
from gpusolve_tpu.utils.timer import Timer


@functools.partial(jax.jit, static_argnames=("params",))
def comp_f(
    state: GridState, params: GridParams
) -> Tuple[GridState, jax.Array]:
    """Nonlinear residual F = newton_f − (A·ũ/h² + γ·ũ·e^ũ) on the finest
    level, stored into level-0 f; returns its L2 norm (reference:
    src/cpu/NewtonSolver.cpp:48-81).

    Implemented as the NONLINEAR-mode residual evaluated at v=ũ with the
    original RHS — identical algebra (the reference also writes interior f
    only, NewtonSolver.cpp:72).
    """
    lvl = state.levels[0]
    h = params.level_h(0)
    nl_params = dataclasses.replace(params, mode=Mode.NONLINEAR)
    F, sumsq = xla.residual(
        lvl.newton_v, state.newton_f, params.level_dims()[0], nl_params, h
    )
    levels = (dataclasses.replace(lvl, f=F),) + state.levels[1:]
    return dataclasses.replace(state, levels=levels), jnp.sqrt(sumsq)


@functools.partial(jax.jit, static_argnames=("params", "shardings"))
def _prepare_find_error(
    state: GridState, params: GridParams, shardings: Optional[Tuple] = None
) -> GridState:
    """Zero the finest v and restrict newton_v down to levels 1..L-2
    (reference: src/cpu/NewtonSolver.cpp:22,88-92)."""
    levels = list(state.levels)
    levels[0] = dataclasses.replace(
        levels[0], v=jnp.zeros_like(levels[0].v)
    )
    dims = params.level_dims()
    for i in range(1, len(levels) - 1):
        nv = xla.restrict_full_weighting(
            levels[i - 1].newton_v, dims[i - 1], dims[i],
            levels[i].newton_v.shape,
        )
        if shardings is not None and shardings[i] is not None:
            nv = jax.lax.with_sharding_constraint(nv, shardings[i])
        levels[i] = dataclasses.replace(levels[i], newton_v=nv)
    return dataclasses.replace(state, levels=tuple(levels))


@functools.partial(jax.jit, static_argnames=("params",))
def _update_newton_v(state: GridState, params: GridParams) -> GridState:
    """newton_v += v on the finest level (reference:
    src/cpu/NewtonSolver.cpp:106-107)."""
    lvl = state.levels[0]
    levels = (
        dataclasses.replace(lvl, newton_v=lvl.newton_v + lvl.v),
    ) + state.levels[1:]
    return dataclasses.replace(state, levels=levels)


def find_error(
    state: GridState,
    params: GridParams,
    shardings: Optional[Tuple] = None,
    timer: Optional[Timer] = None,
    f_norm: Optional[float] = None,
) -> GridState:
    """Solve J(ũ)·e = F with a short inner MG solve and update ũ
    (reference: src/cpu/NewtonSolver.cpp:83-108).

    ``f_norm``: ||F||₂ from the preceding comp_f, if the caller has it.
    The inner system starts at e = 0, so its initial residual is
    ``f - A·0 - γ(1+nv)·0·e^nv = F`` exactly — passing the norm skips
    vc.solve's whole-volume initial residual pass (one less full-grid
    program per Newton step)."""
    tp = vc.trace_params(params)
    state = _prepare_find_error(state, params=tp, shardings=shardings)
    inner = params.replace(maxiter=10, tol=0.1, print_progress=False)
    state, _ = vc.solve(
        state, inner, shardings=shardings, timer=timer,
        initial_residual=f_norm,
    )
    return _update_newton_v(state, params=tp)


def newton_solve(
    state: GridState,
    params: GridParams,
    shardings: Optional[Tuple] = None,
    timer: Optional[Timer] = None,
    initial_residual: Optional[float] = None,
) -> Tuple[GridState, List[float]]:
    """Outer Newton loop (reference: src/cpu/NewtonSolver.cpp:10-44).

    The solution is accumulated in level-0 newton_v.  Returns the final state
    and the outer residual history ``[initial, res_0, ...]``.

    ``initial_residual``: checkpoint-resume fidelity — when given, the stop
    threshold uses the original run's initial residual (see
    gpusolve_tpu.solver.vcycle.solve) and the returned history omits the
    leading entry.
    """
    assert params.mode == Mode.NEWTON
    assert state.newton_f is not None, "build_grid must run in NEWTON mode"
    if timer is None and params.print_progress:
        timer = Timer()
    tp = vc.trace_params(params)

    if initial_residual is None:
        state, initial_j = comp_f(state, params=tp)
        initial = float(initial_j)
        if params.print_progress:
            print(f"Inital newton residual: {initial:.6g}")
        history = [initial]
    else:
        initial = float(initial_residual)
        history = []

    for i in range(params.maxiter):
        t0 = time.perf_counter()
        state, fn = comp_f(state, params=tp)
        # ||F|| doubles as the inner solve's initial residual (the inner
        # system starts at e = 0) — see find_error's f_norm note.
        state = find_error(
            state, params, shardings=shardings, timer=timer,
            f_norm=float(fn),
        )
        state, res = comp_f(state, params=tp)
        if timer is not None:
            with timer.section("sumBuffer"):
                res = float(res)
        else:
            res = float(res)
        history.append(res)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"newton iter: {i} residual: {res:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res <= initial / (1.0 / params.tol):
            break
    return state, history
