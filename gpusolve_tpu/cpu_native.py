"""ctypes bridge to the native C++ CPU backend (csrc/gpusolve_cpu.cpp).

Role parity with the reference's ``GpuSolve-cpu`` target (src/cpu/*): a
native, OpenMP-parallel host solver.  In this framework it serves as
``--backend cpu-native`` and as an independent implementation for
cross-checking the JAX paths.

The shared library is compiled on demand with g++ (cached next to the
source, keyed on a source hash) — the framework stays pip-less and
self-contained.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Tuple

import numpy as np

from gpusolve_tpu.config import GridParams, Mode

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc",
    "gpusolve_cpu.cpp",
)

_lib = None


class _CConfig(ctypes.Structure):
    _fields_ = [
        ("maxiter", ctypes.c_int64),
        ("tol", ctypes.c_double),
        ("dim", ctypes.c_int64 * 3),
        ("mode", ctypes.c_int),
        ("pre_smooth", ctypes.c_int64),
        ("post_smooth", ctypes.c_int64),
        ("omega", ctypes.c_double),
        ("gamma", ctypes.c_double),
        ("stencil_values", ctypes.c_double * 7),
        ("stencil_off", (ctypes.c_int64 * 3) * 7),
    ]


def available() -> bool:
    try:
        return _load() is not None
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with open(_CSRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    build_dir = os.path.join(os.path.dirname(_CSRC), "build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, f"libgpusolve_cpu_{tag}.so")
    if not os.path.exists(so_path):
        # Per-PID temp + atomic rename: concurrent processes (e.g. a test
        # subprocess racing its parent on a fresh source hash) must never
        # interleave writes into one temp file.
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [
            "g++",
            "-O3",
            "-march=native",
            "-fopenmp",
            "-std=c++17",
            "-shared",
            "-fPIC",
            _CSRC,
            "-o",
            tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.gpusolve_cpu_solve.restype = ctypes.c_int64
    lib.gpusolve_cpu_solve.argtypes = [
        ctypes.POINTER(_CConfig),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.gpusolve_cpu_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def _to_cconfig(params: GridParams) -> _CConfig:
    cfg = _CConfig()
    cfg.maxiter = params.maxiter
    cfg.tol = params.tol
    for i, d in enumerate(params.grid_dim):
        cfg.dim[i] = d
    cfg.mode = int(params.mode)
    cfg.pre_smooth = params.pre_smoothing
    cfg.post_smooth = params.post_smoothing
    cfg.omega = params.omega
    cfg.gamma = params.gamma
    for i, v in enumerate(params.stencil.values):
        cfg.stencil_values[i] = v
    for i, (ox, oy, oz) in enumerate(params.stencil.offsets):
        cfg.stencil_off[i][0] = ox
        cfg.stencil_off[i][1] = oy
        cfg.stencil_off[i][2] = oz
    return cfg


def solve_native(
    params: GridParams, with_times: bool = False
):
    """Run the full native solve (any mode).  Returns the padded
    ``(n+2)³`` float64 solution field and the residual history
    ``[initial, res_0, ...]``; with ``with_times`` also the measured
    per-iteration wall ms (the reference's per-cycle Timer,
    src/Timer.cpp:7-27)."""
    lib = _load()
    cfg = _to_cconfig(params)
    nx, ny, nz = params.grid_dim
    sol = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    hist = np.zeros(params.maxiter + 1, dtype=np.float64)
    times = np.zeros(max(1, params.maxiter), dtype=np.float64)
    iters = lib.gpusolve_cpu_solve(
        ctypes.byref(cfg),
        sol.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if iters < 0:
        raise RuntimeError("gpusolve_cpu_solve failed")
    history = [float(h) for h in hist[: iters + 1]]
    if with_times:
        return sol, history, [float(t) for t in times[:iters]]
    return sol, history


def num_threads() -> int:
    return int(_load().gpusolve_cpu_num_threads())
