"""Checkpoint / resume of solver state.

The reference has no checkpointing (SURVEY.md §5 — its only persistence is
the text dump consumed by plotter.py); this adds
save/restore of the solution state so long solves can resume.  Stored as a
compressed .npz of the logical padded fields plus the config fingerprint —
portable, no extra dependencies.

The V-cycle iteration is a stationary relaxation, so resuming from the saved
fields reproduces the remaining iterations exactly (the per-cycle inputs are
just ``v``/``f`` — and ``newton_v``/``newton_f`` in Newton mode).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from gpusolve_tpu.config import GridParams, Mode
from gpusolve_tpu.grid import GridState, build_grid

_FORMAT_VERSION = 1


def _fingerprint(params: GridParams) -> str:
    return (
        f"v{_FORMAT_VERSION};dims={params.grid_dim};mode={int(params.mode)};"
        f"stencil={params.stencil.values}{params.stencil.offsets};"
        f"omega={params.omega};gamma={params.gamma}"
    )


def save_state(
    path: str,
    state: GridState,
    params: GridParams,
    iteration: int = 0,
    history: Optional[List[float]] = None,
) -> None:
    """Write the solver state (all levels' v, plus newton_v/newton_f in
    Newton mode) and progress metadata."""
    arrays = {}
    for l, lvl in enumerate(state.levels):
        arrays[f"v_{l}"] = np.asarray(lvl.v)
        if lvl.newton_v is not None:
            arrays[f"newton_v_{l}"] = np.asarray(lvl.newton_v)
    arrays["f_0"] = np.asarray(state.levels[0].f)
    if state.newton_f is not None:
        arrays["newton_f"] = np.asarray(state.newton_f)
    np.savez_compressed(
        path,
        __fingerprint__=np.array(_fingerprint(params)),
        __iteration__=np.array(iteration),
        __history__=np.array(history if history else [], dtype=np.float64),
        **arrays,
    )


def load_state(path: str, params: GridParams):
    """Rebuild a GridState from a checkpoint.  Returns
    ``(state, iteration, history)``.  Raises on config mismatch."""
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["__fingerprint__"])
        if fp != _fingerprint(params):
            raise ValueError(
                "checkpoint was written for a different problem "
                f"configuration:\n  saved: {fp}\n  "
                f"current: {_fingerprint(params)}"
            )
        state = build_grid(params)
        levels = []
        for l, lvl in enumerate(state.levels):
            import jax.numpy as jnp

            v = jnp.asarray(z[f"v_{l}"])
            kw = {"v": v}
            if f"newton_v_{l}" in z:
                kw["newton_v"] = jnp.asarray(z[f"newton_v_{l}"])
            if l == 0:
                kw["f"] = jnp.asarray(z["f_0"])
            levels.append(dataclasses.replace(lvl, **kw))
        newton_f = state.newton_f
        if "newton_f" in z:
            import jax.numpy as jnp

            newton_f = jnp.asarray(z["newton_f"])
        iteration = int(z["__iteration__"])
        history = [float(h) for h in z["__history__"]]
    return (
        dataclasses.replace(
            state, levels=tuple(levels), newton_f=newton_f
        ),
        iteration,
        history,
    )


# ---------------------------------------------------------------------------
# Explicit-SPMD engine checkpoints (dist/spmd.py state tuples)
# ---------------------------------------------------------------------------
#
# The spmd engine carries its state as a flat tuple of
# global arrays in engine-specific allocations (mesh-aware on distributed
# levels), so their checkpoints are engine/mesh-keyed: resuming requires the
# same mesh shape and engine (the fingerprint enforces it — never a silent
# mismatch).  Arrays are gathered to host on save and resharded by the
# jitted cycle's in_specs on load.


def _spmd_fingerprint(params: GridParams, plan, engine: str) -> str:
    shapes = ";".join(str(tuple(a)) for a in plan.alloc)
    return (
        f"{_fingerprint(params)};mesh={plan.mesh_shape};engine={engine};"
        f"alloc={shapes}"
    )


def save_state_spmd(
    path: str,
    state,
    plan,
    params: GridParams,
    engine: str,
    iteration: int = 0,
    history: Optional[List[float]] = None,
    newton_f=None,
) -> None:
    """Write an spmd-engine state tuple (plus, in Newton mode, the original
    RHS ``newton_f`` — level-0 f holds the Newton residual F between outer
    steps)."""
    arrays = {f"s_{i}": np.asarray(a) for i, a in enumerate(state)}
    if newton_f is not None:
        arrays["newton_f"] = np.asarray(newton_f)
    np.savez_compressed(
        path,
        __fingerprint__=np.array(_spmd_fingerprint(params, plan, engine)),
        __iteration__=np.array(iteration),
        __history__=np.array(history if history else [], dtype=np.float64),
        **arrays,
    )


def load_state_spmd(path: str, params: GridParams, plan, engine: str):
    """Rebuild an spmd state tuple from a checkpoint.  Returns
    ``(state, iteration, history, newton_f)``.  Raises on config, mesh, or
    engine mismatch."""
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        fp = str(z["__fingerprint__"])
        want = _spmd_fingerprint(params, plan, engine)
        if fp != want:
            raise ValueError(
                "checkpoint was written for a different problem/mesh/"
                f"engine configuration:\n  saved: {fp}\n  current: {want}"
            )
        n = sum(1 for k in z.files if k.startswith("s_"))
        state = tuple(jnp.asarray(z[f"s_{i}"]) for i in range(n))
        newton_f = (
            jnp.asarray(z["newton_f"]) if "newton_f" in z.files else None
        )
        iteration = int(z["__iteration__"])
        history = [float(h) for h in z["__history__"]]
    return state, iteration, history, newton_f
