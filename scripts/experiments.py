"""Experiment sweep harness — the runExperiments.py counterpart.

The reference's harness (runExperiments.py) sweeps {impl} × {mode} ×
{resolution}, regex-parses the solver's progress lines, and reports total
solve time per configuration.  This drives the library API directly on the
current JAX device (plus optionally the native C++ CPU backend), collects
per-cycle times and residual sequences, and prints one table + a JSON file.

Usage:
    python scripts/experiments.py [--sizes 63,127,255] [--modes 0,1,2]
        [--backends xla,cpu-native] [--maxiter 10] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(backend: str, mode: int, size: int, maxiter: int):
    from gpusolve_tpu.config import GridParams, Mode, Stencil

    params = GridParams(
        maxiter=maxiter,
        tol=1e-5,
        grid_dim=(size, size, size),
        mode=Mode(mode),
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        print_progress=False,
        dtype="float32",
    )

    if backend == "cpu-native":
        from gpusolve_tpu import cpu_native

        t0 = time.perf_counter()
        _, history = cpu_native.solve_native(
            params.replace(dtype="float64")
        )
        total_ms = (time.perf_counter() - t0) * 1e3
        warm_ms = total_ms  # no compile phase
        return history, total_ms, warm_ms

    from gpusolve_tpu import build_grid, newton_solve, solve

    state = build_grid(params)
    t0 = time.perf_counter()
    if params.mode == Mode.NEWTON:
        state, history = newton_solve(state, params)
    else:
        state, history = solve(state, params)
    total_ms = (time.perf_counter() - t0) * 1e3

    # Warm re-run (compile cached) for the steady-state number.
    state2 = build_grid(params)
    t0 = time.perf_counter()
    if params.mode == Mode.NEWTON:
        state2, history = newton_solve(state2, params)
    else:
        state2, history = solve(state2, params)
    warm_ms = (time.perf_counter() - t0) * 1e3
    return history, total_ms, warm_ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="63,127,255")
    ap.add_argument("--modes", default="0,1,2")
    ap.add_argument("--backends", default="xla")
    ap.add_argument("--maxiter", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if "xla" in args.backends.split(","):
        from gpusolve_tpu.utils import compile_cache

        compile_cache.setup()

    sizes = [int(s) for s in args.sizes.split(",")]
    modes = [int(m) for m in args.modes.split(",")]
    backends = args.backends.split(",")
    mode_names = {0: "LINEAR", 1: "NONLINEAR", 2: "NEWTON"}

    results = []
    hdr = (
        f"{'backend':<12} {'mode':<10} {'size':>5} {'warm ms':>9} "
        f"{'ms/iter':>9} {'iters':>5}  residuals (first→last)"
    )
    print(hdr)
    print("-" * len(hdr))
    for backend in backends:
        for mode in modes:
            for size in sizes:
                history, total_ms, warm_ms = run_one(
                    backend, mode, size, args.maxiter
                )
                iters = len(history) - 1
                per_iter = warm_ms / max(1, iters)
                print(
                    f"{backend:<12} {mode_names[mode]:<10} {size:>5} "
                    f"{warm_ms:>9.1f} {per_iter:>9.1f} {iters:>5}  "
                    f"{history[0]:.3g} → {history[-1]:.3g}",
                    flush=True,
                )
                results.append(
                    {
                        "backend": backend,
                        "mode": mode_names[mode],
                        "size": size,
                        "first_total_ms": round(total_ms, 1),
                        "warm_total_ms": round(warm_ms, 1),
                        "ms_per_iter": round(per_iter, 2),
                        "iters": iters,
                        "residuals": [float(f"{h:.6g}") for h in history],
                    }
                )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
