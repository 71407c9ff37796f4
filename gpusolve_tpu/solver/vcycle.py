"""Multigrid V-cycle driver (linear and nonlinear-FAS) and the solve loop.

Reference semantics: src/cpu/CpuSolver.cpp (the numerical oracle) and its GPU
mirror src/sycl/SyclSolver.cpp.  Structure: the level loop is unrolled at
trace time (each level has static shapes), the entire cycle — smoothing,
residual, transfers, norm — is one jitted computation over the `jnp` ops of
gpusolve_tpu.ops.xla, and the once-per-cycle scalar norm fetch is the only
host synchronisation (the same async profile the reference GPU backend gets
from its sub-queue scheduler, src/sycl/SyclSolver.cpp:86-162, sync point
:361-374).

Multi-device: pass ``shardings`` (one per level) and the same traced code runs
SPMD over a device mesh (see gpusolve_tpu.dist).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from gpusolve_tpu.config import GridParams, Mode
from gpusolve_tpu.grid import GridLevel, GridState
from gpusolve_tpu.ops import xla
from gpusolve_tpu.utils.timer import Timer

# Sub-cycles each schedule recurses into (V per the reference; W/F
# beyond-reference, see config.GridParams.cycle_type).
SUBCYCLES = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}


def level_visits(nlev: int, cycle_type: str) -> List[int]:
    """Times each level is visited per outer cycle: V -> 1, F -> l+1,
    W -> 2^l (the standard gamma-cycle visit counts)."""
    visits = [1] * nlev
    for l in range(1, nlev):
        if cycle_type == "W":
            visits[l] = 2 * visits[l - 1]
        elif cycle_type == "F":
            visits[l] = visits[l - 1] + 1
    return visits


def trace_params(params: GridParams) -> GridParams:
    """Normalise fields the traced computation never reads (maxiter, tol,
    print_progress) so jit caches hit across outer/inner solves — the Newton
    driver temporarily overrides maxiter/tol (src/cpu/NewtonSolver.cpp:94-104)
    and must not trigger a recompile."""
    return dataclasses.replace(
        params, maxiter=0, tol=0.0, print_progress=False
    )


def _constrain(arr, shardings, i):
    if shardings is None or shardings[i] is None or arr is None:
        return arr
    return jax.lax.with_sharding_constraint(arr, shardings[i])


@functools.partial(jax.jit, static_argnames=("params", "shardings"))
def vcycle(
    state: GridState,
    params: GridParams,
    shardings: Optional[Tuple] = None,
) -> Tuple[GridState, jax.Array]:
    """One multigrid cycle (of ``params.cycle_type``); returns the updated
    state and the finest-level residual norm (reference:
    src/cpu/CpuSolver.cpp:85-139)."""
    levels: List[GridLevel] = list(state.levels)
    nlev = len(levels)
    hs = [params.level_h(i) for i in range(nlev)]
    dims = params.level_dims()
    fas = params.mode == Mode.NONLINEAR

    def smooth_level(i: int, n_iter: int) -> None:
        lvl = levels[i]
        with jax.named_scope("smooth"):
            v = xla.jacobi(
                lvl.v, lvl.f, dims[i], params, hs[i], n_iter,
                newton_v=lvl.newton_v,
            )
        levels[i] = dataclasses.replace(lvl, v=_constrain(v, shardings, i))

    def down_step(i: int) -> None:
        """Pre-smooth level i, restrict its residual into level i+1's RHS
        (reference :87-114)."""
        smooth_level(i, params.pre_smoothing)
        lvl = levels[i]
        with jax.named_scope("residual"):
            r, _ = xla.residual(
                lvl.v, lvl.f, dims[i], params, hs[i], newton_v=lvl.newton_v
            )
        r = _constrain(r, shardings, i)
        levels[i] = dataclasses.replace(lvl, r=r)

        nxt = levels[i + 1]
        with jax.named_scope("restrict"):
            f_next = xla.restrict_full_weighting(
                r, dims[i], dims[i + 1], nxt.f.shape
            )
        f_next = _constrain(f_next, shardings, i + 1)
        if not fas:
            levels[i + 1] = dataclasses.replace(
                nxt, f=f_next, v=jnp.zeros_like(nxt.v)
            )
        else:
            # FAS tau correction (reference :100-113): restrict v into both
            # restV and v, add the coarse operator applied to it onto f.
            with jax.named_scope("restrict"):
                rest_v = xla.restrict_full_weighting(
                    levels[i].v, dims[i], dims[i + 1], nxt.rest_v.shape
                )
            rest_v = _constrain(rest_v, shardings, i + 1)
            with jax.named_scope("fas_apply"):
                a_coarse = xla.apply_stencil_fas(
                    rest_v, dims[i + 1], params, hs[i + 1]
                )
            levels[i + 1] = dataclasses.replace(
                nxt,
                f=f_next + a_coarse,
                v=rest_v,
                rest_v=rest_v,
                r=a_coarse,
            )

    def up_step(i: int) -> None:
        """Prolong level i+1's correction onto level i, post-smooth
        (reference :119-135)."""
        if fas:
            levels[i + 1] = dataclasses.replace(
                levels[i + 1], v=levels[i + 1].v - levels[i + 1].rest_v
            )
        lvl = levels[i]
        # Trilinear prolongation, then the coarse-grid correction
        # (reference interpolate :240-290 then `v += e` :130-132).
        with jax.named_scope("interpolate"):
            e = xla.interpolate(
                levels[i + 1].v, dims[i + 1], dims[i], lvl.v.shape
            )
        with jax.named_scope("correct"):
            v = lvl.v + e
        levels[i] = dataclasses.replace(
            lvl, v=_constrain(v, shardings, i), e=e
        )
        smooth_level(i, params.post_smoothing)

    def cycle_at(i: int, kind: str) -> None:
        if i == nlev - 1:
            # Coarsest level: smoothing only, no direct solve (ref :117).
            smooth_level(i, params.pre_smoothing + params.post_smoothing)
            return
        down_step(i)
        for sub in SUBCYCLES[kind]:
            cycle_at(i + 1, sub)
        up_step(i)

    cycle_at(0, params.cycle_type)

    # Final residual + norm (reference :138).
    lvl0 = levels[0]
    with jax.named_scope("norm"):
        r0, sumsq = xla.residual(
            lvl0.v, lvl0.f, dims[0], params, hs[0], newton_v=lvl0.newton_v
        )
    levels[0] = dataclasses.replace(lvl0, r=_constrain(r0, shardings, 0))
    return (
        dataclasses.replace(state, levels=tuple(levels)),
        jnp.sqrt(sumsq),
    )


@functools.partial(jax.jit, static_argnames=("params",))
def residual_norm(
    state: GridState, params: GridParams
) -> Tuple[GridState, jax.Array]:
    """Residual at the finest level, storing r (reference compResidual,
    src/cpu/CpuSolver.cpp:45-83)."""
    lvl = state.levels[0]
    r, sumsq = xla.residual(
        lvl.v, lvl.f, params.level_dims()[0], params, params.level_h(0),
        newton_v=lvl.newton_v,
    )
    levels = (dataclasses.replace(lvl, r=r),) + state.levels[1:]
    return dataclasses.replace(state, levels=levels), jnp.sqrt(sumsq)


# AOT-compiled cycle cache, like the reference's source-keyed kernel cache
# (sycl-gtx handler.h:44-75): compile once per (trace-params, state
# signature), with the *measured* compile wall time recorded into the
# Timer's "compile" counter like the reference's Timer::push("compile")
# instrumentation (handler.h:64-67).
_compiled_cycles: dict = {}


def _state_key(state: GridState) -> Tuple:
    lvl0 = state.levels[0]
    return (
        len(state.levels),
        lvl0.v.shape,
        lvl0.v.dtype.name,
        state.newton_f is not None,
    )


def compiled_cycle(
    state: GridState,
    tp: GridParams,
    shardings: Optional[Tuple],
    timer: Optional[Timer] = None,
):
    """Return a compiled one-cycle callable for this state signature,
    timing any fresh compilation into ``timer``."""
    if shardings is not None:
        # Sharded states evolve their (constraint-derived) shardings between
        # cycles; an AOT executable would reject them — stay on the jit
        # dispatch path, which re-specialises as needed.
        return lambda s: vcycle(s, params=tp, shardings=shardings)
    key = (tp, _state_key(state))
    fn = _compiled_cycles.get(key)
    if fn is None:
        t0 = time.perf_counter()
        fn = vcycle.lower(state, params=tp, shardings=None).compile()
        if timer is not None:
            timer.add("compile", time.perf_counter() - t0)
        _compiled_cycles[key] = fn
    return fn


def solve(
    state: GridState,
    params: GridParams,
    shardings: Optional[Tuple] = None,
    timer: Optional[Timer] = None,
    initial_residual: Optional[float] = None,
) -> Tuple[GridState, List[float]]:
    """Iterate cycles until ``res <= initialResidual·tol`` or maxiter
    (reference: src/cpu/CpuSolver.cpp:12-43; the stop test is written
    ``initial / (1.0/tol)`` at :39 and reproduced verbatim).

    Returns the final state and the residual history
    ``[initial, res_0, res_1, ...]``.

    ``initial_residual``: checkpoint-resume fidelity — when given, the stop
    threshold uses this (the *original* run's initial residual) instead of
    recomputing one from the resumed state, so a resumed solve stops exactly
    where the uninterrupted run would.  The returned history then omits the
    leading initial entry (it already lives in the loaded history).
    """
    if timer is None and params.print_progress:
        timer = Timer()
    tp = trace_params(params)
    if initial_residual is None:
        state, initial = residual_norm(state, params=tp)
        initial = float(initial)
        if params.print_progress:
            print(f"Inital residual: {initial:.6g}")
        history = [initial]
    else:
        initial = float(initial_residual)
        history = []

    cycle = compiled_cycle(state, tp, shardings, timer)
    for i in range(params.maxiter):
        t0 = time.perf_counter()
        state, res = cycle(state)
        # The once-per-cycle device sync; blocks until the async cycle
        # drains, like the reference's sumBuffer host accessor
        # (src/sycl/SyclSolver.cpp:361-374, Timer'd at :288,373).
        if timer is not None:
            with timer.section("sumBuffer"):
                res = float(res)
        else:
            res = float(res)
        history.append(res)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"iter: {i} residual: {res:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res <= initial / (1.0 / params.tol):
            break
    return state, history
