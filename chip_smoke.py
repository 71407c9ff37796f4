"""Smoke test of the solver on one GPU, through the entry points users call.

    python chip_smoke.py               # one card: all default phases
    python chip_smoke.py --four-cards  # four cards: the leg engine only

Default phases (one process, one card):
  1. device      platform, device kind, count, JAX version, nvidia-smi
                 name and power limit, the compile-cache directory;
  2. oracle      the reference's example configs (examples/*_127.conf)
                 through ``cli.main`` at f64 and f32, residual histories
                 against the f64 NumPy oracle (tests/oracle.py);
  3. ops         each op of ops/xla.py at 511³ f32 on one seeded random
                 field against the oracle's op functions, and the count of
                 dot/convolution ops in one compiled cycle;
  4. full width  511³ f32 LINEAR and FAS (10 cycles) and NEWTON (3 outer
                 steps) through the library API, 511³ f64 LINEAR (3 cycles)
                 through ``cli.main``: finite, falling residuals, host-clock
                 ms per cycle, compiled memory analysis, peak device memory.

``--four-cards`` runs only ``solve_spmd``/``newton_solve_spmd`` at 511³ f32
in all three modes on meshes (4,1,1) and (2,2,1), the single-card solve of
the same problem they are compared with, and each card's bytes in use.

It exits non-zero, and prints no result, when JAX finds no GPU or any
phase fails.  The last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

# f64 device run vs the f64 oracle, relative per history entry: what the
# CPU tests hold (tests/test_solver_parity.py); only the summation order
# differs on the card.
F64_RTOL = 1e-8
# f32 device run vs the f64 oracle, relative per entry, over the entries
# whose oracle residual is at least F32_FLOOR_MARGIN times the f32 run's
# smallest residual (its rounding floor).  There the floor's noise moves an
# entry by at most 1/F32_FLOOR_MARGIN; on the CPU the 127³ examples agree
# to 4e-5 over those entries.
F32_RTOL = 1e-3
F32_FLOOR_MARGIN = 100.0
# Per-op f32 device result vs the f64 oracle at 511³: max |got - ref| over
# max |ref|.  A 7-tap stencil in f32 rounds at ~1e-6 of the largest term;
# the norm is a tree sum of 1.3e8 squares (~27 levels of 6e-8).
OP_RTOL = 1e-5
# Leg engine on four cards vs the single-card solve, both f32: per history
# entry |spmd - one| <= SPMD_RTOL * one + floor, where floor is the
# single-card run's smallest residual (its f32 rounding floor).  The same
# arithmetic in another summation order moves a residual by about the floor
# once it nears it, and by ~1e-6 relative well above it.
SPMD_RTOL = 1e-3
# A residual counts as falling when it is below its predecessor, or within
# this factor of the run's smallest residual (the f32 floor, where rounding
# noise moves it both ways).
FLOOR_BAND = 1.1

FULL = (511, 511, 511)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def history_rel(got, ref) -> float:
    """Largest per-entry relative difference of two residual histories;
    inf when their lengths differ."""
    if len(got) != len(ref):
        return float("inf")
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def f32_compared(got, ref, margin=F32_FLOOR_MARGIN):
    """(entries compared, largest relative difference) of an f32 history
    against the f64 oracle over the entries above the f32 floor."""
    floor = min(got)
    n = 0
    while n < min(len(got), len(ref)) and ref[n] >= margin * floor:
        n += 1
    if n == 0:
        return 0, float("inf")
    return n, history_rel(got[:n], ref[:n])


def spmd_excess(got, ref, floor, rtol=SPMD_RTOL) -> float:
    """Largest per-entry |got - ref| / (rtol * |ref| + floor) over the
    entries ``got`` has; <= 1 passes.  inf when ``got`` is longer."""
    if len(got) > len(ref):
        return float("inf")
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref[: len(got)], np.float64)
    return float(np.max(np.abs(got - ref) / (rtol * np.abs(ref) + floor)))


def falling(history, band=FLOOR_BAND) -> bool:
    """Finite, and each residual below its predecessor or at the floor."""
    h = np.asarray(history, np.float64)
    if not np.all(np.isfinite(h)):
        return False
    floor = h.min()
    return all(b < a or b <= band * floor for a, b in zip(h, h[1:]))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _quiet_cli(argv):
    """Run ``cli.main(argv)`` with stdout captured; returns (rc, text)."""
    from gpusolve_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _cli_history(conf: str, dtype: str, tmp: str):
    """Full-precision residual history of a CLI solve (from the checkpoint
    the CLI writes with --save-state)."""
    path = os.path.join(tmp, f"{os.path.basename(conf)}.{dtype}.npz")
    rc, out = _quiet_cli(
        [conf, "--dtype", dtype, "--quiet", "--save-state", path]
    )
    _check(rc == 0, f"cli.main({conf}, {dtype}) returned {rc}:\n{out}")
    with np.load(path) as z:
        return [float(x) for x in z["__history__"]]


def _printed_history(text: str):
    """Residuals from the CLI's progress lines."""
    out = []
    for line in text.splitlines():
        if line.startswith("Inital") or "residual:" in line:
            out.append(float(line.split("residual:")[1].split()[0]))
    return out


def phase_device(dev, jax, count_want):
    from bench import card_info
    from gpusolve_tpu.utils import compile_cache

    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__}")
    print(f"card: {card_info()}")
    print(f"compile cache: {compile_cache.setup()}")
    _check(len(jax.devices()) >= count_want,
           f"need {count_want} devices, have {len(jax.devices())}")


def phase_oracle(tmp):
    import oracle as orc

    import gpusolve_tpu as gs
    from gpusolve_tpu.config import Mode

    for name in ("linear", "nonlinear", "newton"):
        conf = os.path.join(ROOT, "examples", f"{name}_127.conf")
        p = gs.parse_config(conf, print_progress=False)
        grid = orc.OracleGrid(p)
        ref = (
            orc.newton_solve(grid) if p.mode == Mode.NEWTON
            else orc.solve(grid)
        )
        h64 = _cli_history(conf, "float64", tmp)
        e64 = history_rel(h64, ref)
        print(f"oracle {name} 127^3 f64: {len(h64)} entries, last "
              f"{h64[-1]:.6e}, max rel {e64:.3e} (bound {F64_RTOL:g})")
        _check(e64 <= F64_RTOL, f"{name} f64 history off the oracle")
        h32 = _cli_history(conf, "float32", tmp)
        n, e32 = f32_compared(h32, ref)
        print(f"oracle {name} 127^3 f32: {n} entries above the f32 floor "
              f"{min(h32):.3e}, max rel {e32:.3e} (bound {F32_RTOL:g})")
        _check(n >= 2 and e32 <= F32_RTOL,
               f"{name} f32 history off the oracle")


def phase_ops(jax):
    import jax.numpy as jnp
    import oracle as orc

    from gpusolve_tpu.config import GridParams, Mode, Stencil
    from gpusolve_tpu.grid import alloc_shape, build_grid
    from gpusolve_tpu.ops import xla
    from gpusolve_tpu.solver import vcycle as vc

    rng = np.random.default_rng(1234)
    base = GridParams(
        maxiter=1, tol=1e-5, grid_dim=FULL, mode=Mode.LINEAR,
        pre_smoothing=3, post_smoothing=3, omega=0.8, gamma=1.0,
        stencil=Stencil.poisson_7pt(), print_progress=False,
    )
    d0, d1 = base.level_dims()[:2]
    h0, h1 = base.level_h(0), base.level_h(1)
    lv0 = orc.OracleLevel(d0, h0, with_e=True)
    lv1 = orc.OracleLevel(d1, h1, with_e=True)
    interior = (slice(1, -1),) * 3
    for a in (lv0.v, lv0.f, lv0.newton_v, lv1.v):
        a[interior] = rng.random(a[interior].shape)

    def dev(a, shape):
        out = np.zeros(shape, np.float32)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return jnp.asarray(out)

    s0, s1 = alloc_shape(d0), alloc_shape(d1)
    v0, f0, nv0 = dev(lv0.v, s0), dev(lv0.f, s0), dev(lv0.newton_v, s0)
    v1 = dev(lv1.v, s1)

    def crop(a, like):
        return np.asarray(a)[tuple(slice(0, s) for s in like.shape)]

    for mode in (Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON):
        p = base.replace(mode=mode)
        grid = SimpleNamespace(params=p, levels=[lv0, lv1])
        nv = nv0 if mode == Mode.NEWTON else None
        got = jax.jit(
            lambda v, f, nv: xla.jacobi(v, f, d0, p, h0, 1, newton_v=nv)
        )(v0, f0, nv)
        v_saved = lv0.v.copy()
        orc.jacobi(grid, 0, 1)
        err = rel_err(crop(got, lv0.v), lv0.v)
        lv0.v[:] = v_saved
        print(f"op jacobi {mode.name}: rel {err:.3e} (bound {OP_RTOL:g})")
        _check(err <= OP_RTOL, f"jacobi {mode.name}")
        r, ss = jax.jit(
            lambda v, f, nv: xla.residual(v, f, d0, p, h0, newton_v=nv)
        )(v0, f0, nv)
        ref_norm = orc.comp_residual(grid, 0)
        err = rel_err(crop(r, lv0.r), lv0.r)
        nerr = abs(float(jnp.sqrt(ss)) - ref_norm) / ref_norm
        print(f"op residual {mode.name}: rel {err:.3e}, norm rel "
              f"{nerr:.3e} (bound {OP_RTOL:g})")
        _check(err <= OP_RTOL and nerr <= OP_RTOL, f"residual {mode.name}")

    got = jax.jit(
        lambda a: xla.restrict_full_weighting(a, d0, d1, s1)
    )(v0)
    coarse = np.zeros_like(lv1.f)
    orc.restrict(lv0.v, coarse)
    err = rel_err(crop(got, coarse), coarse)
    print(f"op restrict: rel {err:.3e} (bound {OP_RTOL:g})")
    _check(err <= OP_RTOL, "restrict")

    grid = SimpleNamespace(params=base, levels=[lv0, lv1])
    got = jax.jit(lambda a: xla.interpolate(a, d1, d0, s0))(v1)
    orc.interpolate(grid, 0)
    err = rel_err(crop(got, lv0.e), lv0.e)
    print(f"op interpolate: rel {err:.3e} (bound {OP_RTOL:g})")
    _check(err <= OP_RTOL, "interpolate")

    p = base.replace(mode=Mode.NONLINEAR)
    grid = SimpleNamespace(params=p, levels=[lv0, lv1])
    got = jax.jit(lambda a: xla.apply_stencil_fas(a, d0, p, h0))(v0)
    orc.apply_stencil(grid, 0, lv0.v)
    err = rel_err(crop(got, lv0.r)[interior], lv0.r[interior])
    print(f"op fas_apply: rel {err:.3e} (bound {OP_RTOL:g})")
    _check(err <= OP_RTOL, "fas_apply")
    del v0, f0, nv0, v1, got, r

    state = build_grid(base)
    hlo = vc.vcycle.lower(
        state, params=vc.trace_params(base)
    ).compile().as_text()
    dots = hlo.count(" dot(") + hlo.count(" convolution(")
    print(f"optimized HLO of one {FULL[0]}^3 cycle: {dots} dot/convolution "
          "ops")
    _check(dots == 0 or "precision_config" in hlo,
           "a dot without an explicit precision")


def _solve_full(gs, jax, params):
    """One full-width solve; returns (history, ms per cycle)."""
    from gpusolve_tpu.config import Mode
    from gpusolve_tpu.solver import vcycle as vc

    run = gs.newton_solve if params.mode == Mode.NEWTON else gs.solve
    run(gs.build_grid(params), params.replace(maxiter=1))  # compile
    state = gs.build_grid(params)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, hist = run(state, params)  # fetches each cycle's norm
    ms = (time.perf_counter() - t0) * 1e3 / (len(hist) - 1)
    if params.mode != Mode.NEWTON:
        compiled = vc.vcycle.lower(
            state, params=vc.trace_params(params)
        ).compile()
        print(f"  memory_analysis: {compiled.memory_analysis()}")
    del state
    gc.collect()
    return hist, ms


def phase_full(jax, dev, tmp):
    import gpusolve_tpu as gs
    from gpusolve_tpu.config import Mode

    for name, mode, n in (
        ("linear", Mode.LINEAR, 10),
        ("nonlinear", Mode.NONLINEAR, 10),
        ("newton", Mode.NEWTON, 3),
    ):
        p = gs.parse_config(
            os.path.join(ROOT, "examples", f"{name}_127.conf"),
            grid_dim=FULL, maxiter=n, tol=1e-30, print_progress=False,
        )
        hist, ms = _solve_full(gs, jax, p)
        stats = dev.memory_stats()
        print(f"full {mode.name} 511^3 f32: {n} steps, residuals "
              f"{[float(f'{h:.6g}') for h in hist]}, {ms:.3f} ms per "
              "step (host clock, value fetch each step), peak_bytes_in_use "
              f"{stats['peak_bytes_in_use']}")
        _check(falling(hist) and hist[-1] < hist[0],
               f"{mode.name} 511^3 residuals do not fall")

    conf = os.path.join(tmp, "linear_511.conf")
    with open(os.path.join(ROOT, "examples", "linear_127.conf")) as f:
        toks = f.read().split()
    toks[0], toks[2:5] = "3", ["511"] * 3
    with open(conf, "w") as f:
        f.write(" ".join(toks) + "\n")
    t0 = time.perf_counter()
    rc, out = _quiet_cli([conf, "--dtype", "float64"])
    wall = time.perf_counter() - t0
    hist = _printed_history(out)
    stats = dev.memory_stats()
    print(f"full LINEAR 511^3 f64 (cli.main): rc {rc}, residuals {hist}, "
          f"{wall:.1f} s wall with compile, peak_bytes_in_use "
          f"{stats['peak_bytes_in_use']}")
    _check(rc == 0 and len(hist) == 4 and falling(hist),
           "f64 511^3 residuals do not fall")


def phase_four_cards(jax):
    import gpusolve_tpu as gs
    from gpusolve_tpu.config import Mode
    from gpusolve_tpu.dist import make_mesh
    from gpusolve_tpu.dist.spmd import newton_solve_spmd, solve_spmd

    cases = []
    for name, mode, n, n_ref in (
        ("linear", Mode.LINEAR, 4, 10),
        ("nonlinear", Mode.NONLINEAR, 4, 10),
        ("newton", Mode.NEWTON, 2, 3),
    ):
        p = gs.parse_config(
            os.path.join(ROOT, "examples", f"{name}_127.conf"),
            grid_dim=FULL, maxiter=n, tol=1e-30, print_progress=False,
        )
        run = gs.newton_solve if mode == Mode.NEWTON else gs.solve
        ref = run(gs.build_grid(p), p.replace(maxiter=n_ref))[1]
        gc.collect()
        cases.append((p, ref))
    for shape in ((4, 1, 1), (2, 2, 1)):
        mesh = make_mesh(shape)
        for p, ref in cases:
            mode = p.mode
            floor = min(ref)
            spmd = newton_solve_spmd if mode == Mode.NEWTON else solve_spmd
            t0 = time.perf_counter()
            state, hist, plan = spmd(p, mesh)
            jax.block_until_ready(state)
            wall = time.perf_counter() - t0
            in_use = [d.memory_stats()["bytes_in_use"] for d in jax.devices()]
            err = history_rel(hist, ref[: len(hist)])
            excess = spmd_excess(hist, ref, floor)
            print(f"four-cards {mode.name} 511^3 f32 mesh {shape}: "
                  f"{plan.n_dist} distributed levels, residuals "
                  f"{[float(f'{h:.6g}') for h in hist]}, one card "
                  f"{[float(f'{h:.6g}') for h in ref[: len(hist)]]}, max "
                  f"rel {err:.3e}, max |diff|/({SPMD_RTOL:g}*one + floor "
                  f"{floor:.4g}) = {excess:.3f} (bound 1), bytes_in_use "
                  f"per card {in_use}, {wall:.1f} s wall with compile",
                  flush=True)
            _check(excess <= 1.0, f"{mode.name} {shape} off one card")
            _check(min(in_use) > 0.5 * max(in_use),
                   f"state piled on one card: {in_use}")
            del state
            gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the leg engine on four cards and what it is "
        "compared with",
    )
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)

    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four_cards:
            phases = [
                ("device", lambda: phase_device(dev, jax, 4)),
                ("four_cards", lambda: phase_four_cards(jax)),
            ]
        else:
            phases = [
                ("device", lambda: phase_device(dev, jax, 1)),
                ("oracle", lambda: phase_oracle(tmp)),
                ("ops", lambda: phase_ops(jax)),
                ("full", lambda: phase_full(jax, dev, tmp)),
            ]
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:
                traceback.print_exc()
                failed.append(name)
            print(f"phase {name}: "
                  f"{'FAILED' if name in failed else 'ok'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
