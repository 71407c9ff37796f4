"""Command-line entry point: ``gpusolve <path/to/config.conf>``.

Mirrors the reference CLI surface (src/main.cpp:15-114): a positional config
file in the 14-line format, mode-dispatch to the linear/FAS solver or the
Newton driver, and the same progress lines (``Inital residual: …``,
``iter: N residual: R Took Xms``) that the reference's experiment harness
regex-parses (runExperiments.py:46).

Extensions beyond the reference surface (flags, all optional):
  --dtype {float32,float64}   storage dtype (float64 is the reference's own
                              precision)
  --backend {xla,cpu-native}  JAX device path, or the C++/OpenMP host solver
  --mesh X,Y,Z                3-D device mesh for multi-device domain
                              decomposition (default: single device)
  --refine                    mixed-precision iterative refinement: f64
                              residual accuracy with f32 multigrid cycles
                              (solver/refine.py)
  --dump PATH                 write the final solution in Vector3::dump text
                              format (src/cpu/Vector3.cpp:56-78)
  --validate                  print max-abs error vs the analytic solution
                              (plotter.py parity, nonlinear/Newton modes)
"""

from __future__ import annotations

import argparse
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gpusolve",
        description="3D geometric-multigrid solver",
    )
    ap.add_argument("config", help="path to config file (14-line format)")
    ap.add_argument(
        "--dtype", choices=["float32", "float64"], default="float32"
    )
    ap.add_argument(
        "--backend",
        choices=["xla", "cpu-native"],
        default="xla",
        help="xla runs on the JAX device; cpu-native runs the C++/OpenMP "
        "host backend (csrc/gpusolve_cpu.cpp)",
    )
    ap.add_argument(
        "--mesh",
        default=None,
        help="comma-separated 3-D device mesh, e.g. 2,2,1 (default: 1 device)",
    )
    ap.add_argument(
        "--dist-engine",
        choices=["auto", "gspmd", "spmd"],
        default="auto",
        help="distribution engine with --mesh: spmd (explicit "
        "shard_map+ppermute halo exchange) or gspmd (partitioner-inserted "
        "collectives over the same jnp ops — the debugging/fallback "
        "engine); auto picks spmd wherever it is eligible",
    )
    ap.add_argument("--dump", default=None, metavar="PATH")
    ap.add_argument("--validate", action="store_true")
    ap.add_argument(
        "--save-state", default=None, metavar="PATH",
        help="write a resumable checkpoint (.npz) after solving",
    )
    ap.add_argument(
        "--load-state", default=None, metavar="PATH",
        help="resume from a checkpoint written by --save-state",
    )
    ap.add_argument(
        "--devices", action="store_true",
        help="print the visible JAX devices before solving (the analogue "
        "of the reference's OpenCL platform/device enumeration, "
        "src/sycl/ContextHandles.h:9-33)",
    )
    ap.add_argument(
        "--quiet", action="store_true", help="suppress progress lines"
    )
    ap.add_argument(
        "--check-every", type=int, default=1, metavar="K",
        help="with the spmd engine: run K cycles per device dispatch; "
        "the stop test runs between batches, up to K-1 cycles past tol "
        "(NEWTON mode: K inner cycles per dispatch)",
    )
    ap.add_argument(
        "--cycle", choices=["V", "W", "F"], default="V",
        help="multigrid cycling schedule (beyond-reference: the reference "
        "is V-only): W recurses twice per level, F recurses F-then-V; "
        "one outer cycle = one stop-test iteration either way.  W/F "
        "visit coarse levels more often per cycle and pay off at tight "
        "tolerances",
    )
    ap.add_argument(
        "--refine", action="store_true",
        help="mixed-precision iterative refinement: f64-accurate solves "
        "with f32 multigrid cycles (f64 outer defect + f32 V-cycle "
        "corrections; see solver/refine.py). tol is the f64 "
        "relative-residual target, maxiter the outer-step limit",
    )
    ap.add_argument(
        "--refine-inner-tol", type=float, default=1e-3, metavar="T",
        help="relative tolerance of each inner f32 multigrid solve under "
        "--refine (values below ~kappa(A)*eps_f32 buy nothing)",
    )
    ap.add_argument(
        "--explain-backend", action="store_true",
        help="print (stderr) which engine this configuration runs — "
        "per-level layout for distributed solves",
    )
    ap.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the solve into DIR "
        "(view with TensorBoard / xprof; the analogue of the reference's "
        "Timer instrumentation, src/Timer.cpp:13-27)",
    )
    return ap


def _spmd_notes(plan, _explain) -> None:
    """--explain-backend detail for the explicit spmd engine."""
    nd = plan.n_dist
    fold = (
        f" (z mesh axis folded into y: data mesh {plan.mesh_shape})"
        if tuple(plan.device_mesh) != tuple(plan.mesh_shape) else ""
    )
    _explain([
        f"dist-engine=spmd ({nd} distributed levels, "
        f"{plan.nlev - nd} replicated){fold}",
    ] + [f"level {l}: block {plan.block[l]}" for l in range(nd)])


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    if not os.path.isfile(args.config):
        # Reference wording: src/main.cpp:24
        print(
            f"{args.config} does not exist or is not a file", file=sys.stderr
        )
        return 1

    native = args.backend == "cpu-native"
    if args.refine:
        incompat = [
            ("--dtype float64", args.dtype == "float64"),
            ("--backend cpu-native", native),
            ("--save-state/--load-state",
             bool(args.save_state or args.load_state)),
        ]
        bad = [name for name, hit in incompat if hit]
        if bad:
            print(
                f"--refine is incompatible with {', '.join(bad)} "
                "(f32 inner solves with an f64 outer defect)",
                file=sys.stderr,
            )
            return 1
    if not native:
        import jax

        from gpusolve_tpu.utils import compile_cache

        compile_cache.setup()
        if args.dtype == "float64" or args.refine:
            jax.config.update("jax_enable_x64", True)

    from gpusolve_tpu import parse_config
    from gpusolve_tpu.config import Mode
    from gpusolve_tpu.utils.dump import compare_analytic, dump_field

    print(f"Using config file {args.config}")
    try:
        params = parse_config(
            args.config,
            dtype="float64" if native else args.dtype,
            print_progress=not args.quiet,
            cycle_type=args.cycle,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    if args.profile and native:
        print(
            "--profile needs a JAX device backend (jax.profiler); the "
            "cpu-native backend has no trace hooks",
            file=sys.stderr,
        )
        return 1

    if args.cycle != "V":
        if native:
            print(
                "--cycle W/F is not available on the cpu-native backend",
                file=sys.stderr,
            )
            return 1

    # Resolve the distribution engine: the explicit spmd engine is the
    # default wherever it is eligible (all modes, V/W/F, --refine); gspmd
    # remains for too-small/single-level grids and as an explicitly
    # requested debugging engine.
    dist_engine = args.dist_engine
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(t) for t in args.mesh.split(","))
        except ValueError:
            print(f"invalid --mesh {args.mesh!r}", file=sys.stderr)
            return 1
        if len(mesh_shape) != 3 or any(m < 1 for m in mesh_shape):
            print(f"invalid --mesh {args.mesh!r}", file=sys.stderr)
            return 1
        if dist_engine == "auto":
            from gpusolve_tpu.dist.spmd import spmd_eligible

            reason = spmd_eligible(params, mesh_shape)
            if reason is None:
                dist_engine = "spmd"
            else:
                dist_engine = "gspmd"
                print(
                    f"note: using the gspmd engine ({reason})",
                    file=sys.stderr,
                )

    def _explain(lines):
        if args.explain_backend:
            for ln in lines:
                print(f"backend: {ln}", file=sys.stderr)

    spmd = bool(args.mesh) and dist_engine == "spmd"
    if args.check_every > 1 and not spmd:
        print(
            "--check-every batches cycles on the spmd engine (--mesh) only",
            file=sys.stderr,
        )
        return 1

    # Reference announces the mode (src/main.cpp:44-51).
    mode_msg = {
        Mode.LINEAR: "Solving linear problem",
        Mode.NONLINEAR: "Solving nonlinear problem",
        Mode.NEWTON: "Solving newton problem",
    }
    print(mode_msg[params.mode])
    if not params.properly_nested:
        print(
            "warning: grid dims are not 2^k-1-nested; coarse grids are "
            "geometrically misaligned and multigrid convergence is not "
            "guaranteed (this matches the reference's behavior)",
            file=sys.stderr,
        )

    import numpy as np

    if native:
        from gpusolve_tpu import cpu_native

        solution, history, cycle_ms = cpu_native.solve_native(
            params, with_times=True
        )
        if params.print_progress:
            if params.mode == Mode.NEWTON:
                print(f"Inital newton residual: {history[0]:.6g}")
            else:
                print(f"Inital residual: {history[0]:.6g}")
            word = "newton iter" if params.mode == Mode.NEWTON else "iter"
            for i, res in enumerate(history[1:]):
                # Real measured per-cycle wall time from the native loop
                # (csrc solve_loop/newton_loop), matching the reference's
                # per-cycle Timer prints (src/Timer.cpp:13-27).
                print(
                    f"{word}: {i} residual: {res:.6g} "
                    f"Took {int(cycle_ms[i])}ms"
                )
    else:
        import contextlib

        from gpusolve_tpu import build_grid, newton_solve, solve

        if args.devices:
            import jax

            for i, d in enumerate(jax.devices()):
                kind = getattr(d, "device_kind", "?")
                print(f"Device [{i}]: {kind} ({d.platform})")
            print(f"Using device [0]")

        profile_cm = contextlib.nullcontext()
        if args.profile:
            import jax

            profile_cm = jax.profiler.trace(
                args.profile, create_perfetto_trace=True
            )

        if args.refine:
            from gpusolve_tpu.solver.refine import (
                solve_refine,
                solve_refine_spmd,
            )

            refine_shardings = None
            if spmd:
                from gpusolve_tpu.dist import make_mesh

                with profile_cm:
                    u, history = solve_refine_spmd(
                        params, make_mesh(mesh_shape),
                        inner_tol=args.refine_inner_tol,
                    )
            else:
                if args.mesh:
                    from gpusolve_tpu.dist import (
                        level_shardings,
                        make_mesh,
                    )

                    print(
                        "note: --refine on the gspmd engine (the "
                        "debugging path); --dist-engine spmd is the "
                        "default wherever eligible",
                        file=sys.stderr,
                    )
                    refine_shardings = level_shardings(
                        params.replace(dtype="float32"),
                        make_mesh(mesh_shape),
                    )
                with profile_cm:
                    u, history = solve_refine(
                        params, inner_tol=args.refine_inner_tol,
                        shardings=refine_shardings,
                    )
            if args.profile:
                print(f"Wrote profiler trace to {args.profile}")
            nx, ny, nz = params.grid_dim
            solution = np.asarray(u)[: nx + 2, : ny + 2, : nz + 2]
            if args.dump:
                dump_field(solution, args.dump)
                print(f"Dumped solution to {args.dump}")
            if args.validate:
                if params.mode == Mode.LINEAR:
                    print("--validate only applies to nonlinear/newton modes")
                else:
                    err = compare_analytic(solution, params.h)
                    print(f"max-abs error vs analytic solution: {err:.6g}")
            return 0

        shardings = None
        if args.mesh:
            from gpusolve_tpu.dist import level_shardings, make_mesh

            mesh = make_mesh(mesh_shape)
            if spmd:
                from gpusolve_tpu.dist.spmd import (
                    build_spmd_solver,
                    gather_solution,
                    newton_solve_spmd,
                    solve_spmd,
                )
                from gpusolve_tpu.utils.checkpoint import (
                    load_state_spmd,
                    save_state_spmd,
                )

                engine_tag = "spmd"
                try:
                    _, _, plan = build_spmd_solver(params, mesh)
                except ValueError as e:
                    print(str(e), file=sys.stderr)
                    return 1
                _spmd_notes(plan, _explain)
                sp_state = None
                history0: list = []
                initial_residual = None
                newton_f0 = None
                if args.load_state:
                    if not os.path.isfile(args.load_state):
                        print(
                            f"{args.load_state} does not exist or is not "
                            "a file", file=sys.stderr,
                        )
                        return 1
                    try:
                        sp_state, it0, history0, newton_f0 = (
                            load_state_spmd(
                                args.load_state, params, plan, engine_tag
                            )
                        )
                    except ValueError as e:
                        print(str(e), file=sys.stderr)
                        return 1
                    print(f"Resumed from {args.load_state} "
                          f"(iteration {it0})")
                    if history0:
                        initial_residual = history0[0]
                with profile_cm:
                    if params.mode == Mode.NEWTON:
                        sp_state, history, plan = newton_solve_spmd(
                            params, mesh,
                            state=sp_state, newton_f=newton_f0,
                            initial_residual=initial_residual,
                            check_every=args.check_every,
                        )
                        newton_f0 = plan.newton_f
                        solution_np = gather_solution(
                            sp_state, plan, mesh, which=2
                        )
                    else:
                        sp_state, history, plan = solve_spmd(
                            params, mesh,
                            state=sp_state,
                            initial_residual=initial_residual,
                            check_every=args.check_every,
                        )
                        solution_np = gather_solution(sp_state, plan, mesh)
                if args.profile:
                    print(f"Wrote profiler trace to {args.profile}")
                if args.save_state:
                    combined = history0 + history
                    save_state_spmd(
                        args.save_state, sp_state, plan, params,
                        engine_tag, iteration=len(combined) - 1,
                        history=combined, newton_f=newton_f0,
                    )
                    print(f"Saved state to {args.save_state}")
                if args.dump:
                    from gpusolve_tpu.utils.dump import dump_field

                    dump_field(solution_np, args.dump)
                    print(f"Dumped solution to {args.dump}")
                if args.validate:
                    from gpusolve_tpu.utils.dump import compare_analytic

                    err = compare_analytic(solution_np, params.h)
                    print(
                        f"max-abs error vs analytic solution: {err:.6g}"
                    )
                return 0
            shardings = level_shardings(params, mesh)
            print(
                "note: the gspmd engine is the debugging/fallback path "
                "(partitioner-inserted collectives); use --dist-engine "
                "spmd (the default wherever eligible)",
                file=sys.stderr,
            )
            _explain([
                "dist-engine=gspmd (XLA partitioner-inserted collectives)",
            ])

        if shardings is None:
            _explain(["single device: XLA ops (ops/xla.py)"])
        state = build_grid(params)
        history0 = []
        initial_residual = None
        if args.load_state:
            from gpusolve_tpu.utils.checkpoint import load_state

            if not os.path.isfile(args.load_state):
                print(
                    f"{args.load_state} does not exist or is not a file",
                    file=sys.stderr,
                )
                return 1
            try:
                state, it0, history0 = load_state(args.load_state, params)
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 1
            print(f"Resumed from {args.load_state} (iteration {it0})")
            # Resume fidelity: the stop threshold must keep using the
            # *original* run's initial residual (history[0]), not one
            # recomputed from the resumed state.
            if history0:
                initial_residual = history0[0]
        with profile_cm:
            if params.mode == Mode.NEWTON:
                state, history = newton_solve(
                    state, params, shardings=shardings,
                    initial_residual=initial_residual,
                )
                solution = state.levels[0].newton_v
            else:
                state, history = solve(
                    state, params, shardings=shardings,
                    initial_residual=initial_residual,
                )
                solution = state.levels[0].v
        if args.profile:
            print(f"Wrote profiler trace to {args.profile}")
        combined = history0 + history
        if args.save_state:
            from gpusolve_tpu.utils.checkpoint import save_state

            save_state(
                args.save_state, state, params,
                iteration=len(combined) - 1,
                history=combined,
            )
            print(f"Saved state to {args.save_state}")
        # Slice the aligned allocation down to the logical padded
        # region (gpusolve_tpu.grid.alloc_shape) for dump/validation parity.
        nx, ny, nz = params.grid_dim
        solution = np.asarray(solution)[: nx + 2, : ny + 2, : nz + 2]

    if args.dump:
        dump_field(solution, args.dump)
        print(f"Dumped solution to {args.dump}")
    if args.validate:
        if params.mode == Mode.LINEAR:
            print("--validate only applies to nonlinear/newton modes")
        else:
            err = compare_analytic(solution, params.h)
            print(f"max-abs error vs analytic solution: {err:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
