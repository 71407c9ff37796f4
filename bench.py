"""Headline benchmark: stencil-nnz/s on a full V-cycle at 511³ (BASELINE.md).

Runs on a GPU only: it exits non-zero when JAX finds no GPU, and never falls
back to the CPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
...extras}, including the card's name and power limit as ``nvidia-smi``
reports them.  The per-op device-time breakdown of a traced window goes to
stderr.

``vs_baseline`` is measured against the roofline-derived target from
BASELINE.json: the throughput an ideal *pass-per-op* implementation (the
reference's kernel structure, src/sycl/SyclSolver.cpp:164-466) would reach
at 90% of the card's published memory bandwidth with zero padding traffic::

    vs_baseline = achieved nnz/s / (nnz / (min_bytes / (0.90 * peak_bw)))

``min_bytes`` is the op-by-op minimum memory traffic for one cycle counted
on DENSE logical volumes (no alignment padding):

  * Jacobi sweep      read v, f; write v            -> 12 B/point
  * residual          read v, f; write r            -> 12 B/point
  * restriction       read fine r; write coarse f
  * coarse v zero     write
  * prolongation+add  read coarse v; read v; write v (fused correction)

Environment knobs: BENCH_SIZE (default 511), BENCH_CYCLES (default 60),
BENCH_MODE (default 0 = linear).

Usage::

    python bench.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import json
import re
import shutil
import subprocess
import tempfile
import time

# Published peak memory bandwidth per card, GB/s, keyed by
# ``jax.devices()[0].device_kind``.  An unknown card is an error, never a
# default.
_PEAK_BW = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 80 GB HBM3 at
    # 3.35 TB/s.
    "NVIDIA H100 80GB HBM3": 3350.0,
}

# Named scopes the cycle puts on its ops (solver/vcycle.py), in the order
# they are reported.
OP_SCOPES = (
    "smooth", "residual", "restrict", "fas_apply", "interpolate",
    "correct", "norm",
)


def peak_bandwidth_gbps(device) -> float:
    kind = getattr(device, "device_kind", "")
    if kind not in _PEAK_BW:
        raise ValueError(
            f"no published peak bandwidth for device_kind {kind!r}; add it "
            "to bench._PEAK_BW with its source"
        )
    return _PEAK_BW[kind]


def require_gpu():
    """The first JAX device, which must be a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found platform {dev.platform!r}"
        )
    return dev


def card_info() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def vcycle_cost_model(params, itemsize: int):
    """(stencil_nnz, min_bytes) for one cycle of the reference's
    pass-per-op structure, counted on dense logical (interior+halo) volumes.

    Honors ``params.cycle_type``: W/F cycles visit level ``l`` more than
    once per cycle (solver/vcycle.level_visits), so their nnz/bytes reflect
    the work actually done rather than the V-cycle visit model.
    """
    from gpusolve_tpu.solver.vcycle import level_visits

    dims = params.level_dims()
    nlev = params.num_levels
    pre, post = params.pre_smoothing, params.post_smoothing
    visits = level_visits(nlev, params.cycle_type)
    nnz = 0
    bytes_ = 0
    for i, (nx, ny, nz) in enumerate(dims):
        interior = nx * ny * nz
        dense = (nx + 2) * (ny + 2) * (nz + 2)
        sweeps = (pre + post) * visits[i]
        # one residual+restrict per non-coarsest visit, plus the
        # once-per-cycle convergence-check residual at the finest level
        residuals = (visits[i] + (1 if i == 0 else 0)) if i < nlev - 1 else 0
        nnz += (sweeps + residuals) * 7 * interior
        bytes_ += (sweeps + residuals) * 3 * dense * itemsize
        if i < nlev - 1:
            cx, cy, cz = dims[i + 1]
            cdense = (cx + 2) * (cy + 2) * (cz + 2)
            # per visit: restrict r->f + zero coarse v, then fused
            # prolongate+correct (read coarse v, read v, write v)
            bytes_ += visits[i] * (
                (dense + cdense) * itemsize + cdense * itemsize
                + (cdense + 2 * dense) * itemsize
            )
    return nnz, bytes_


def _kernel_key(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def fusion_scopes(hlo_text: str) -> dict:
    """Map each instruction of an optimized HLO module to the first of
    ``OP_SCOPES`` in its ``op_name`` metadata, keyed the way the GPU names
    the instruction's kernel (dots and dashes become underscores)."""
    scopes = {}
    for m in re.finditer(
        r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]+)"',
        hlo_text, re.MULTILINE,
    ):
        parts = m.group(2).split("/")
        scope = next((s for s in OP_SCOPES if s in parts), "other")
        scopes[_kernel_key(m.group(1))] = scope
    return scopes


def device_trace(trace_dir: str, hlo_text: str = "") -> dict:
    """Reduce a jax.profiler trace of one GPU to metrics.

    Returns ``{"window_ns", "busy_ns", "idle_share", "ops": {kernel:
    [count, device_ns, scope]}, "scopes": {scope: device_ns}}``: busy is the
    union of the kernel intervals on the first GPU's compute streams, the
    window spans the first kernel start to the last kernel end, and each
    kernel takes the named scope (``OP_SCOPES``) of its instruction in
    ``hlo_text`` — the optimized HLO of the traced program — or "other".
    """
    import glob

    import jax

    paths = glob.glob(
        os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")
    )
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(paths[0])
    planes = sorted(
        (p for p in pd.planes if p.name.startswith("/device:GPU")),
        key=lambda p: p.name,
    )
    if not planes:
        raise RuntimeError("trace has no GPU device plane")
    events = sorted(
        (
            e for ln in planes[0].lines if "Compute" in ln.name
            for e in ln.events if e.duration_ns > 0
        ),
        key=lambda e: e.start_ns,
    )
    if not events:
        raise RuntimeError(
            "no kernels on the GPU's compute streams: "
            f"{[ln.name for ln in planes[0].lines]}"
        )
    scope_of = fusion_scopes(hlo_text)
    ops: dict = {}
    scopes: dict = {}
    busy = 0.0
    cur_s = cur_e = None
    for e in events:
        scope = scope_of.get(_kernel_key(e.name), "other")
        rec = ops.setdefault(e.name, [0, 0.0, scope])
        rec[0] += 1
        rec[1] += e.duration_ns
        scopes[scope] = scopes.get(scope, 0.0) + e.duration_ns
        s, t = e.start_ns, e.start_ns + e.duration_ns
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    end = max(e.start_ns + e.duration_ns for e in events)
    window = end - events[0].start_ns
    return {
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window,
        "ops": ops,
        "scopes": scopes,
    }


def copy_bandwidth_gbps() -> float:
    """Device-side bandwidth of a large copy-like pass (read 1 + write 1
    volume of 2 GB per step) in this process, timed from a profiler trace
    so launch and fetch overhead do not count."""
    import jax
    import jax.numpy as jnp

    n = 512 * 1024 * 1024  # f32 elements: 2 GB, far larger than L2
    reps = 20

    @jax.jit
    def chain(x):
        for _ in range(reps):
            # The barrier keeps XLA from fusing the chain into one pass.
            x = jax.lax.optimization_barrier(x * 1.0000001 + 1e-12)
        return x

    x = jnp.ones((n,), jnp.float32)
    chain(x).block_until_ready()  # compile
    tdir = tempfile.mkdtemp(prefix="bench_copy_")
    try:
        with jax.profiler.trace(tdir):
            chain(x).block_until_ready()
        busy = device_trace(tdir)["busy_ns"]
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    return 2 * 4 * n * reps / busy


def main() -> None:
    size = int(os.environ.get("BENCH_SIZE", "511"))
    cycles = int(os.environ.get("BENCH_CYCLES", "60"))
    mode_num = int(os.environ.get("BENCH_MODE", "0"))

    dev = require_gpu()
    peak = peak_bandwidth_gbps(dev)
    card = card_info()

    import jax

    from gpusolve_tpu import build_grid
    from gpusolve_tpu.config import GridParams, Mode, Stencil
    from gpusolve_tpu.solver import vcycle as vc
    from gpusolve_tpu.utils import compile_cache

    compile_cache.setup()
    params = GridParams(
        maxiter=cycles,
        tol=1e-30,  # never stop early
        grid_dim=(size, size, size),
        mode=Mode(mode_num),
        pre_smoothing=3,
        post_smoothing=3,
        omega=0.8,
        gamma=1.0,
        stencil=Stencil.poisson_7pt(),
        print_progress=False,
        dtype="float32",
    )
    tp = vc.trace_params(params)

    def fresh_state():
        state = build_grid(params)
        state, r0 = vc.residual_norm(state, params=tp)
        return state, float(r0)

    def run_solve():
        """One full solve (maxiter cycles, no early stop) from a fresh grid;
        returns wall seconds for the cycle loop only (initial residual and
        state construction excluded)."""
        state, r0 = fresh_state()
        t0 = time.perf_counter()
        vc.solve(state, params, initial_residual=r0)
        return time.perf_counter() - t0

    run_solve()  # compile
    dt = min(run_solve() for _ in range(2))
    per_cycle = dt / cycles

    itemsize = 4
    nnz, min_bytes = vcycle_cost_model(params, itemsize)
    nnz_per_s = nnz / per_cycle
    effective_gbps = min_bytes / per_cycle / 1e9
    bw_fraction = effective_gbps / peak
    target_fraction = 0.9  # BASELINE.md: >=90% of roofline on the smoother
    vs_baseline = bw_fraction / target_fraction

    # Device-side view of a short steady window (5 cycles).
    state, r0 = fresh_state()
    hlo = vc.compiled_cycle(state, tp, None).as_text()
    tdir = tempfile.mkdtemp(prefix="bench_prof_")
    try:
        with jax.profiler.trace(tdir):
            vc.solve(state, params.replace(maxiter=5), initial_residual=r0)
        tr = device_trace(tdir, hlo)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    device_ms = tr["busy_ns"] / 5 / 1e6
    copy_gbps = copy_bandwidth_gbps()

    for name, (count, ns, scope) in sorted(
        tr["ops"].items(), key=lambda kv: -kv[1][1]
    ):
        print(
            f"op {scope:12s} {name:40s} x{count / 5:<5g} "
            f"{ns / 5 / 1e6:9.4f} ms/cycle",
            file=sys.stderr,
        )
    out = {
        "metric": f"vcycle_stencil_nnz_per_s_{size}cubed",
        "value": nnz_per_s / 1e9,
        "unit": "Gnnz/s",
        "vs_baseline": vs_baseline,
        "per_cycle_ms": per_cycle * 1e3,
        "device_per_cycle_ms": device_ms,
        "device_idle_share": tr["idle_share"],
        "scope_ms_per_cycle": {
            s: ns / 5 / 1e6 for s, ns in tr["scopes"].items()
        },
        "effective_hbm_gbps": effective_gbps,
        "hbm_fraction": bw_fraction,
        "peak_hbm_gbps": peak,
        "copy_gbps": copy_gbps,
        "device": dev.device_kind,
        "card": card,
        "mode": Mode(mode_num).name,
        "cycles": cycles,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
