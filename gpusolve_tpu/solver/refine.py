"""Mixed-precision iterative refinement: float64-accurate solves at
float32 multigrid speed.

Beyond-reference capability (the reference is ``double`` end-to-end,
src/cpu/CpuSolver.cpp).  Instead of running the whole multigrid hierarchy in
f64, only the O(N) outer defect computation runs in f64 while every V-cycle —
the actual work — runs in float32:

LINEAR mode — classical iterative refinement (Wilkinson):
    r = f − A·u/h²            float64, one stencil sweep
    solve  A·e = r/s          float32 multigrid, s = ‖r‖₂ scaling
    u += s·e                  float64 accumulation
The attainable residual is set by the f64 residual/accumulation; the f32
inner solve only bounds the per-outer contraction, at
``max(inner_tol, κ(A)·eps_f32)`` (κ ≈ (2/(πh))² ⇒ ~1e5·6e-8 ≈ 6e-3 at 511³),
so a few outers reach ~1e-13 relative — far below anything a pure-f32 solve
can touch (~1e-6).

NONLINEAR / NEWTON modes — inexact-Newton defect correction on
``-Δu + γ·u·e^u = f`` (the same outer structure as the reference's Newton
driver, src/cpu/NewtonSolver.cpp:10-44, with the residual in f64):
    F = f − (A·u/h² + γ·u·e^u)   float64
    solve  J(u)·e = F/s          float32 NEWTON-mode multigrid (frozen u)
    u += s·e                     float64
Inexact Newton with inner relative error η < 1 converges to the true root;
the accuracy limit again comes only from the f64 F.  (NONLINEAR mode shares
this outer: FAS is an *algorithm* for the same equation, and a pure-f32 FAS
solve cannot pass the f32 floor — under refinement the correction equation
is the Jacobian system, reference src/cpu/NewtonSolver.cpp:48-81.)

The scaling ``s = ‖r‖₂`` keeps the inner problem O(1) as the defect shrinks
toward 1e-13·‖f‖ — without it the late outers would underflow f32.

Usage: ``solve_refine(params)`` with ``params.dtype == "float32"`` (the inner
dtype) and ``params.tol`` as the f64 relative-residual target; requires
``jax.config.jax_enable_x64`` (the CLI's ``--refine`` flag enables it).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from gpusolve_tpu.config import GridParams, Mode
from gpusolve_tpu.grid import GridState, _device_rhs, alloc_shape, build_grid
from gpusolve_tpu.ops import xla
from gpusolve_tpu.solver import newton as newton_mod
from gpusolve_tpu.solver import vcycle as vc
from gpusolve_tpu.utils.timer import Timer


def _params32(params: GridParams, inner_iters: int,
              inner_tol: float) -> GridParams:
    """The inner float32 solver's configuration.

    Non-linear modes solve the Jacobian correction system, i.e. NEWTON-mode
    multigrid with the frozen linearisation point (reference
    src/cpu/NewtonSolver.cpp:83-104's inner solve)."""
    mode32 = Mode.LINEAR if params.mode == Mode.LINEAR else Mode.NEWTON
    return params.replace(
        dtype="float32", mode=mode32, maxiter=inner_iters, tol=inner_tol,
        print_progress=False,
    )


def _hi_key(params: GridParams) -> GridParams:
    """Normalise fields the f64 defect computation never reads so its jit
    cache hits across solve_refine calls with different maxiter/tol."""
    return params.replace(maxiter=0, tol=0.0, print_progress=False)


@functools.partial(jax.jit, static_argnames=("params",))
def _hi_residual(u: jax.Array, f: jax.Array,
                 params: GridParams) -> Tuple[jax.Array, jax.Array]:
    """f64 defect and its L2 norm on the finest level.

    LINEAR: r = f − A·u/h² (src/cpu/CpuSolver.cpp:45-61); other modes the
    full nonlinear residual F = f − (A·u/h² + γ·u·e^u)
    (src/cpu/NewtonSolver.cpp:48-81) — i.e. the NONLINEAR-mode residual
    evaluated at v = u."""
    p = params if params.mode == Mode.LINEAR else params.replace(
        mode=Mode.NONLINEAR
    )
    r, sumsq = xla.residual(
        u, f, params.level_dims()[0], p, params.level_h(0)
    )
    return r, jnp.sqrt(sumsq)


@functools.partial(
    jax.jit, static_argnames=("dims", "newton"), donate_argnums=(0, 1)
)
def _inject(v32: jax.Array, f32_old: jax.Array, r_hi: jax.Array,
            s: jax.Array, u_hi: jax.Array, dims, newton: bool):
    """Per-outer device prep: scaled-f32 RHS, zeroed correction, and (Newton)
    the frozen f32 linearisation point.  ``s`` stays a device scalar so the
    jit never respecialises per outer."""
    nx, ny, nz = dims
    sl = (slice(1, nx + 1), slice(1, ny + 1), slice(1, nz + 1))
    f32 = f32_old.at[sl].set((r_hi[sl] / s).astype(jnp.float32))
    v32 = jnp.zeros_like(v32)
    nv32 = u_hi.astype(jnp.float32) if newton else None
    return f32, v32, nv32


@functools.partial(jax.jit, static_argnames=("dims",), donate_argnums=(0,))
def _accumulate(u_hi: jax.Array, e32: jax.Array, s: jax.Array, dims):
    """u += s·e over the interior (f64)."""
    nx, ny, nz = dims
    sl = (slice(1, nx + 1), slice(1, ny + 1), slice(1, nz + 1))
    return u_hi.at[sl].add(s * e32[sl].astype(u_hi.dtype))


def hi_rhs(params: GridParams) -> jax.Array:
    """The finest-level RHS in device float64 (on-device analytic fill —
    grid._device_rhs semantics; a host transfer would be ~1 GB at 511³)."""
    return _device_rhs(params, jnp.float64)


def solve_refine(
    params: GridParams,
    inner_tol: float = 1e-3,
    inner_iters: int = 20,
    timer: Optional[Timer] = None,
    state32: Optional[GridState] = None,
    shardings: Optional[Tuple] = None,
) -> Tuple[jax.Array, List[float]]:
    """Iterate f64 defect → f32 multigrid correction until
    ``res ≤ initial·tol`` (the reference stop test, src/cpu/CpuSolver.cpp:39)
    or ``params.maxiter`` outer steps.

    Returns ``(u, history)``: the float64 solution on the finest level
    (alloc-shaped, padded) and the f64 residual-norm history
    ``[initial, res_0, ...]``.  ``params.maxiter``/``params.tol`` govern the
    *outer* iteration; ``inner_tol``/``inner_iters`` the f32 multigrid solve
    of each correction equation (inner tolerances below ~κ(A)·eps_f32 buy
    nothing — see module docstring).

    ``shardings``: per-level ``NamedSharding`` tuple (dist.level_shardings)
    for f64-accurate *distributed* solves — the f64 outer arrays live on the
    finest level's sharding and the inner f32 V-cycles run under the GSPMD
    engine (solver.vcycle with shardings).
    """
    if not jax.config.jax_enable_x64:
        raise ValueError(
            "solve_refine needs jax_enable_x64 for the f64 outer defect "
            "(the CLI --refine flag enables it)"
        )
    if params.dtype != "float32":
        raise ValueError(
            "solve_refine's storage dtype is the inner dtype and must be "
            f"float32 (got {params.dtype}); for pure-f64 runs use "
            "--dtype float64 without --refine"
        )
    if timer is None and params.print_progress:
        timer = Timer()
    dims = params.level_dims()[0]
    newton = params.mode != Mode.LINEAR

    p32 = _params32(params, inner_iters, inner_tol)
    if state32 is None:
        state32 = build_grid(p32)
        if shardings is not None:
            from gpusolve_tpu.dist.sharding import shard_state

            state32 = shard_state(state32, shardings)
    if state32.newton_f is not None:
        # The inner Jacobian solves never read newton_f (only the outer
        # newton_solve driver does), and build_grid aliases it to the same
        # buffer as levels[0].f — which _inject donates each outer step.
        state32 = dataclasses.replace(state32, newton_f=None)
    tp32 = vc.trace_params(p32)

    u = jnp.zeros(alloc_shape(dims), jnp.float64)
    f_hi = hi_rhs(params)
    if shardings is not None:
        from gpusolve_tpu.dist.sharding import _place

        u = _place(u, sh=shardings[0])
        f_hi = _place(f_hi, sh=shardings[0])
    hk = _hi_key(params)

    r_hi, res = _hi_residual(u, f_hi, hk)
    initial = float(res)
    word = "newton iter" if params.mode == Mode.NEWTON else "iter"
    if params.print_progress:
        name = "newton residual" if params.mode == Mode.NEWTON else "residual"
        print(f"Inital {name}: {initial:.6g}")
    history = [initial]

    for i in range(params.maxiter):
        t0 = time.perf_counter()
        s = res.astype(jnp.float64)
        lvl0 = state32.levels[0]
        f32, v32, nv32 = _inject(
            lvl0.v, lvl0.f, r_hi, s, u, dims, newton
        )
        kw = dict(v=v32, f=f32)
        if newton:
            kw["newton_v"] = nv32
        state32 = dataclasses.replace(
            state32,
            levels=(dataclasses.replace(lvl0, **kw),) + state32.levels[1:],
        )
        if newton:
            # Restrict the frozen linearisation point to levels 1..L-2
            # — never the coarsest (the reference quirk,
            # src/cpu/NewtonSolver.cpp:88-92).
            state32 = newton_mod._prepare_find_error(
                state32, params=tp32, shardings=shardings
            )
        state32, _ = vc.solve(state32, p32, shardings=shardings, timer=timer)
        u = _accumulate(u, state32.levels[0].v, s, dims)
        r_hi, res = _hi_residual(u, f_hi, hk)
        if timer is not None:
            with timer.section("sumBuffer"):
                res_f = float(res)
        else:
            res_f = float(res)
        history.append(res_f)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"{word}: {i} residual: {res_f:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res_f <= initial / (1.0 / params.tol):
            break
    return u, history


# ---------------------------------------------------------------------------
# Distributed refinement on the explicit spmd engine
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("dims", "newton", "alloc")
)
def _inject_spmd(r_hi: jax.Array, s: jax.Array, u_hi: jax.Array,
                 dims, alloc, newton: bool):
    """Scaled-f32 level-0 RHS (and Newton linearisation point) in the
    spmd engine's mesh-aware global allocation (interiors of the two
    paddings coincide at [1..n])."""
    nx, ny, nz = dims
    sl = (slice(1, nx + 1), slice(1, ny + 1), slice(1, nz + 1))
    f32 = jnp.zeros(alloc, jnp.float32).at[sl].set(
        (r_hi[sl] / s).astype(jnp.float32)
    )
    nv32 = None
    if newton:
        nv32 = jnp.zeros(alloc, jnp.float32).at[sl].set(
            u_hi[sl].astype(jnp.float32)
        )
    return f32, nv32


@functools.partial(jax.jit, static_argnames=("dims",), donate_argnums=(0,))
def _accumulate_spmd(u_hi: jax.Array, e32: jax.Array, s: jax.Array, dims):
    nx, ny, nz = dims
    sl = (slice(1, nx + 1), slice(1, ny + 1), slice(1, nz + 1))
    return u_hi.at[sl].add(s * e32[sl].astype(u_hi.dtype))


def solve_refine_spmd(
    params: GridParams,
    mesh,
    inner_tol: float = 1e-3,
    inner_iters: int = 20,
    timer: Optional[Timer] = None,
    cutoff: int = 4,
) -> Tuple[jax.Array, List[float]]:
    """``solve_refine`` with the inner f32 multigrid on the explicit spmd
    engine (dist/spmd.py) instead of the gspmd path.

    The f64 outer arrays are global alloc_shape arrays sharded on the
    finest level's spec; each outer step injects the scaled defect into
    the engine's mesh-aware level-0 allocation (interiors coincide),
    runs an inner LINEAR/NEWTON spmd solve, and accumulates the
    correction in f64."""
    if not jax.config.jax_enable_x64:
        raise ValueError(
            "solve_refine needs jax_enable_x64 for the f64 outer defect "
            "(the CLI --refine flag enables it)"
        )
    if params.dtype != "float32":
        raise ValueError(
            "solve_refine's storage dtype is the inner dtype and must be "
            f"float32 (got {params.dtype})"
        )
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpusolve_tpu.dist.spmd import (
        _newton_helpers,
        build_spmd_solver,
        solve_spmd,
    )

    if timer is None and params.print_progress:
        timer = Timer()
    dims = params.level_dims()[0]
    newton = params.mode != Mode.LINEAR
    p32 = _params32(params, inner_iters, inner_tol)

    init_fn, _, plan = build_spmd_solver(p32, mesh, cutoff)
    sp_state = list(init_fn())
    n_arr = 3 if newton else 2
    nd, nlev = plan.n_dist, plan.nlev

    spec0 = NamedSharding(mesh, P("x", plan.names[1], None))
    u = jax.device_put(jnp.zeros(alloc_shape(dims), jnp.float64), spec0)
    f_hi = jax.device_put(hi_rhs(params), spec0)
    hk = _hi_key(params)

    r_hi, res = _hi_residual(u, f_hi, hk)
    initial = float(res)
    word = "newton iter" if params.mode == Mode.NEWTON else "iter"
    if params.print_progress:
        name = (
            "newton residual" if params.mode == Mode.NEWTON
            else "residual"
        )
        print(f"Inital {name}: {initial:.6g}")
    history = [initial]

    helpers = None
    if newton:
        helpers = _newton_helpers(p32, mesh, plan)

    for i in range(params.maxiter):
        t0 = time.perf_counter()
        s = res.astype(jnp.float64)
        f32g, nv32g = _inject_spmd(
            r_hi, s, u, dims, tuple(plan.alloc[0]), newton
        )
        for l in range(nlev):
            base = n_arr * l
            sp_state[base] = jnp.zeros_like(sp_state[base])
            if l == 0:
                sp_state[1] = f32g
            if newton:
                sp_state[base + 2] = (
                    nv32g if l == 0
                    else jnp.zeros_like(sp_state[base + 2])
                )
        if newton:
            # Restrict the frozen linearisation point to levels
            # 1..L-2 — never the coarsest (the reference quirk,
            # src/cpu/NewtonSolver.cpp:88-92).
            _, restrict_nv_fn, _ = helpers
            nvs = restrict_nv_fn(
                *[sp_state[n_arr * l + 2] for l in range(nlev)]
            )
            for l in range(nlev):
                sp_state[n_arr * l + 2] = nvs[l]
        st, _, _ = solve_spmd(
            p32, mesh, cutoff, state=tuple(sp_state), plan=plan,
            check_every=inner_iters,
        )
        sp_state = list(st)
        u = _accumulate_spmd(u, sp_state[0], s, dims)
        r_hi, res = _hi_residual(u, f_hi, hk)
        if timer is not None:
            with timer.section("sumBuffer"):
                res_f = float(res)
        else:
            res_f = float(res)
        history.append(res_f)
        if params.print_progress:
            ms = int((time.perf_counter() - t0) * 1000)
            line = f"{word}: {i} residual: {res_f:.6g} Took {ms}ms"
            if timer is not None:
                line += timer.suffix()
            print(line)
        if res_f <= initial / (1.0 / params.tol):
            break
    return u, history
