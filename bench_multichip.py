"""Weak/strong-scaling bench over a device mesh (BASELINE.md ≥80% target).

Runs the explicit-halo SPMD engine (gpusolve_tpu.dist.spmd) over an
``NX×NY×NZ`` mesh of GPUs and reports per-card stencil throughput, so
scaling efficiency is ``per_chip_nnz_per_s(mesh) / per_chip_nnz_per_s(1)``.
Prints ONE JSON line per run, with the card's name and power limit.  It
exits non-zero when JAX finds no GPU.

Usage::

    python bench_multichip.py --mesh 4,1,1 --size 511     # four cards
    python bench_multichip.py --mesh 1,1,1 --size 511     # one-card ref

Multi-process runs call ``gpusolve_tpu.dist.multihost.initialize`` (env
driven).  Weak scaling: pass ``--size`` as the PER-CARD extent and
``--weak`` to scale the global grid with the mesh (global = per-card extent
× mesh extent, rounded to the nearest 2^k−1 nestable size).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def nearest_nested(n: int) -> int:
    """Nearest 2^k−1 to ``n`` (≥15) — multigrid needs nestable level dims."""
    n = max(n, 15)
    lo = (1 << (n + 1).bit_length() - 1) - 1
    hi = 2 * lo + 1
    return lo if n - lo <= hi - n else hi


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,1,1",
                    help="mesh shape NX,NY,NZ (product = chips used)")
    ap.add_argument("--size", type=int, default=127,
                    help="grid extent (global; per-chip with --weak)")
    ap.add_argument("--weak", action="store_true",
                    help="scale global grid with the mesh (weak scaling)")
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--check-every", type=int, default=0,
                    help="cycles per dispatch (default: all in one batch)")
    ap.add_argument("--mode", type=int, default=0)
    ap.add_argument("--cycle", choices=["V", "W", "F"], default="V",
                    help="cycling schedule (beyond-reference)")
    ap.add_argument("--cutoff", type=int, default=4,
                    help="per-shard extent below which levels replicate")
    args = ap.parse_args()

    mesh_shape = tuple(int(s) for s in args.mesh.split(","))
    assert len(mesh_shape) == 3
    n_chips = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]

    import jax

    from bench import (
        card_info,
        peak_bandwidth_gbps,
        require_gpu,
        vcycle_cost_model,
    )
    from gpusolve_tpu.config import GridParams, Mode, Stencil
    from gpusolve_tpu.dist import multihost, solve_spmd
    from gpusolve_tpu.dist.mesh import make_mesh
    from gpusolve_tpu.utils import compile_cache

    multihost.initialize()  # no-op single-process; env-driven otherwise
    dev = require_gpu()
    compile_cache.setup()

    if args.weak:
        size = nearest_nested(args.size * max(mesh_shape))
    else:
        size = args.size

    params = GridParams(
        maxiter=args.cycles,
        tol=1e-30,  # never stop early
        grid_dim=(size, size, size),
        mode=Mode(args.mode),
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=40.0 if Mode(args.mode) != Mode.LINEAR else 1.0,
        stencil=Stencil.poisson_7pt(),
        print_progress=False,
        cycle_type=args.cycle,
    )

    devices = jax.devices()
    if len(devices) < n_chips:
        raise SystemExit(
            f"mesh {mesh_shape} needs {n_chips} devices, have {len(devices)}"
        )
    mesh = make_mesh(mesh_shape, devices=devices[:n_chips])

    # Warm-up run compiles everything.
    warm = params.replace(maxiter=1)
    state, _, plan = solve_spmd(warm, mesh, cutoff=args.cutoff)

    ck = args.check_every or args.cycles
    if ck > 1:  # pre-compile the batched dispatch outside the timed region
        solve_spmd(
            params.replace(maxiter=ck), mesh, cutoff=args.cutoff,
            state=state, plan=plan, initial_residual=1.0, check_every=ck,
        )
    t0 = time.perf_counter()
    _, history, _ = solve_spmd(
        params, mesh, cutoff=args.cutoff, state=state, plan=plan,
        initial_residual=1.0, check_every=ck,
    )
    dt = time.perf_counter() - t0
    per_cycle = dt / args.cycles

    itemsize = 4 if params.dtype == "float32" else 8
    nnz, _ = vcycle_cost_model(params, itemsize)
    per_chip = nnz / per_cycle / n_chips
    peak = peak_bandwidth_gbps(dev)

    print(json.dumps({
        "metric": f"spmd_per_chip_nnz_per_s_{size}cubed",
        "value": per_chip / 1e9,
        "unit": "Gnnz/s/chip",
        "mesh": list(mesh_shape),
        "chips": n_chips,
        "global_size": size,
        "per_cycle_ms": per_cycle * 1e3,
        "total_gnnz_per_s": nnz / per_cycle / 1e9,
        "mode": Mode(args.mode).name,
        "cycle": args.cycle,  # nnz model scales with W/F level visits
        "cycles": args.cycles,
        "check_every": ck,
        "final_residual": history[-1] if history else None,
        "data_mesh": list(plan.mesh_shape),
        "distributed_levels": plan.n_dist,
        "peak_hbm_gbps_per_chip": peak,
        "device": dev.device_kind,
        "card": card_info(),
        "processes": jax.process_count(),
    }))


if __name__ == "__main__":
    main()
