"""NumPy float64 oracle: a faithful re-expression of the reference CPU solver.

This is the in-repo stand-in for the reference's ``GpuSolve-cpu`` numerical
behavior (src/cpu/CpuSolver.cpp, src/cpu/CpuGridData.cpp,
src/cpu/NewtonSolver.cpp) — the parity contract the framework is tested
against (SURVEY.md §4).  It deliberately mirrors the reference's *pass
structure* (e.g. jacobi = materialise full residual, then update), not the
framework's fused formulation, so agreement between the two is meaningful.

Loop nests are vectorised with NumPy slices whose bounds are derived
one-for-one from the C++ loop bounds (cited per function).  float64
throughout, like the reference's ``double``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from gpusolve_tpu.config import GridParams, Mode


class OracleLevel:
    def __init__(self, dims, h, with_e):
        shape = (dims[0] + 2, dims[1] + 2, dims[2] + 2)
        self.dims = dims
        self.h = h
        self.v = np.zeros(shape)
        self.rest_v = np.zeros(shape)
        self.newton_v = np.zeros(shape)
        self.f = np.zeros(shape)
        self.r = np.zeros(shape)
        self.e = np.zeros(shape) if with_e else None


class OracleGrid:
    """Level hierarchy + analytic RHS (reference: src/cpu/CpuGridData.cpp)."""

    def __init__(self, params: GridParams):
        self.params = params
        p = params
        maxlevel = int(math.floor(math.log(min(p.grid_dim)) / math.log(2.0))) + 1
        self.levels: List[OracleLevel] = []
        dims = p.grid_dim
        for i in range(maxlevel):
            if i > 0:
                dims = (dims[0] // 2, dims[1] // 2, dims[2] // 2)
            h = 1.0 / (dims[1] + 1)
            self.levels.append(OracleLevel(dims, h, with_e=i + 1 != maxlevel))
        self.newton_f = None

        # Finest-level RHS (reference: src/cpu/CpuGridData.cpp:45-78).
        lvl = self.levels[0]
        nx, ny, nz = lvl.dims
        h = p.h
        if p.mode == Mode.LINEAR:
            def f0(t):
                return 100.0 * (t * (t - 1.0)) ** 4

            def f2(t):
                return (
                    100.0 * 4.0 * (t - 1.0) ** 2 * t * t
                    * (14.0 * t * t - 14.0 * t + 3.0)
                )

            x = np.arange(nx) * h
            y = np.arange(ny) * h
            z = np.arange(nz) * h
            X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
            lvl.f[1:-1, 1:-1, 1:-1] = -(
                f2(X) * f0(Y) * f0(Z)
                + f0(X) * f2(Y) * f0(Z)
                + f0(X) * f0(Y) * f2(Z)
            )
        else:
            # CPU fills the whole padded cube (:62-76); interior values match
            # the device convention either way.
            x = np.arange(nx + 2) * h
            y = np.arange(ny + 2) * h
            z = np.arange(nz + 2) * h
            X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
            gx, gy, gz = X - X * X, Y - Y * Y, Z - Z * Z
            lvl.f[:] = (
                2.0 * (gy * gz + gx * gz + gx * gy)
                + p.gamma * gx * gy * gz * np.exp(gx * gy * gz)
            )


def _stencil_sum(grid: OracleGrid, v: np.ndarray, level: OracleLevel):
    """Interior Σ sᵢ v[x+oᵢ] / h² (reference: src/cpu/CpuSolver.cpp:56-61)."""
    nx, ny, nz = level.dims
    acc = np.zeros((nx, ny, nz))
    for val, (ox, oy, oz) in zip(
        grid.params.stencil.values, grid.params.stencil.offsets
    ):
        acc += val * v[
            1 + ox : 1 + ox + nx, 1 + oy : 1 + oy + ny, 1 + oz : 1 + oz + nz
        ]
    return acc / (level.h * level.h)


def comp_residual(grid: OracleGrid, ln: int) -> float:
    """Writes level r, returns ‖r‖₂ (reference: src/cpu/CpuSolver.cpp:45-83)."""
    level = grid.levels[ln]
    s = _stencil_sum(grid, level.v, level)
    vi = level.v[1:-1, 1:-1, 1:-1]
    if grid.params.mode == Mode.NEWTON:
        nvi = level.newton_v[1:-1, 1:-1, 1:-1]
        s = s + grid.params.gamma * (1.0 + nvi) * vi * np.exp(nvi)
    elif grid.params.mode == Mode.NONLINEAR:
        s = s + grid.params.gamma * vi * np.exp(vi)
    r = level.f[1:-1, 1:-1, 1:-1] - s
    level.r[1:-1, 1:-1, 1:-1] = r
    return float(np.sqrt(np.sum(r * r)))


def jacobi(grid: OracleGrid, ln: int, maxiter: int) -> None:
    """Damped Jacobi, two-pass like the reference (src/cpu/CpuSolver.cpp:141-179)."""
    level = grid.levels[ln]
    p = grid.params
    pre_fac = p.stencil.values[0] / (level.h * level.h)
    alpha = (level.h * level.h) / p.stencil.values[0]
    for _ in range(maxiter):
        comp_residual(grid, ln)
        vi = level.v[1:-1, 1:-1, 1:-1]
        ri = level.r[1:-1, 1:-1, 1:-1]
        if p.mode == Mode.LINEAR:
            new_v = vi + p.omega * (alpha * ri)
        elif p.mode == Mode.NONLINEAR:
            ex = np.exp(vi)
            denom = pre_fac + p.gamma * (1.0 + vi) * ex
            new_v = vi + p.omega * (ri / denom)
        else:
            nvi = level.newton_v[1:-1, 1:-1, 1:-1]
            ex = np.exp(nvi)
            denom = pre_fac + p.gamma * (1.0 + nvi) * ex
            new_v = vi + p.omega * (ri / denom)
        level.v[1:-1, 1:-1, 1:-1] = new_v


def apply_stencil(grid: OracleGrid, ln: int, v: np.ndarray) -> None:
    """A(v)/h² + γ·v·e^v → level r (reference: src/cpu/CpuSolver.cpp:182-209)."""
    level = grid.levels[ln]
    s = _stencil_sum(grid, v, level)
    vi = v[1:-1, 1:-1, 1:-1]
    level.r[1:-1, 1:-1, 1:-1] = s + grid.params.gamma * vi * np.exp(vi)


def restrict(fine: np.ndarray, coarse: np.ndarray) -> None:
    """27-point full weighting (reference: src/cpu/CpuSolver.cpp:211-238)."""
    cX, cY, cZ = coarse.shape

    def taps(n, off):
        return slice(2 + off, 2 + off + 2 * (n - 2) - 1, 2)

    acc = np.zeros((cX - 2, cY - 2, cZ - 2))
    for ii in (-1, 0, 1):
        for jj in (-1, 0, 1):
            for kk in (-1, 0, 1):
                fac = (
                    0.125
                    * ((2.0 - abs(ii)) / 2.0)
                    * ((2.0 - abs(jj)) / 2.0)
                    * ((2.0 - abs(kk)) / 2.0)
                )
                acc += fac * fine[taps(cX, ii), taps(cY, jj), taps(cZ, kk)]
    coarse[1:-1, 1:-1, 1:-1] = acc


def interpolate(grid: OracleGrid, ln: int) -> None:
    """4-pass trilinear prolongation v[ln+1] → e[ln]
    (reference: src/cpu/CpuSolver.cpp:240-290)."""
    coarse = grid.levels[ln + 1].v
    fine = grid.levels[ln].e
    fX, fY, fZ = fine.shape
    # prepare (:247-255): fine[x] = coarse[x/2] for even x < dim-1
    nx = len(range(0, fX - 1, 2))
    ny = len(range(0, fY - 1, 2))
    nz = len(range(0, fZ - 1, 2))
    fine[0 : fX - 1 : 2, 0 : fY - 1 : 2, 0 : fZ - 1 : 2] = coarse[
        :nx, :ny, :nz
    ]
    # x-pass (:257-266): even x with x+2 <= fX-1, even y,z over full range
    fine[1 : fX - 1 : 2, 0:fY:2, 0:fZ:2] = 0.5 * (
        fine[0 : fX - 2 : 2, 0:fY:2, 0:fZ:2] + fine[2:fX:2, 0:fY:2, 0:fZ:2]
    )
    # y-pass (:268-277): all x
    fine[:, 1 : fY - 1 : 2, 0:fZ:2] = 0.5 * (
        fine[:, 0 : fY - 2 : 2, 0:fZ:2] + fine[:, 2:fY:2, 0:fZ:2]
    )
    # z-pass (:279-288): all x, y
    fine[:, :, 1 : fZ - 1 : 2] = 0.5 * (
        fine[:, :, 0 : fZ - 2 : 2] + fine[:, :, 2:fZ:2]
    )


_SUBCYCLES = {"V": ("V",), "W": ("W", "W"), "F": ("F", "V")}


def _cycle(grid: OracleGrid, i: int, kind: str) -> None:
    """One multigrid cycle rooted at level ``i`` (reference V-cycle:
    src/cpu/CpuSolver.cpp:85-139; W/F are the standard gamma-cycle
    generalisations — beyond-reference, mirroring gpusolve_tpu)."""
    p = grid.params
    nlev = len(grid.levels)
    if i == nlev - 1:
        jacobi(grid, i, p.pre_smoothing + p.post_smoothing)
        return
    jacobi(grid, i, p.pre_smoothing)
    nxt = grid.levels[i + 1]
    comp_residual(grid, i)
    restrict(grid.levels[i].r, nxt.f)
    if p.mode != Mode.NONLINEAR:
        nxt.v[:] = 0.0
    else:
        restrict(grid.levels[i].v, nxt.rest_v)
        restrict(grid.levels[i].v, nxt.v)
        apply_stencil(grid, i + 1, nxt.rest_v)
        nxt.f += nxt.r
    for sub in _SUBCYCLES[kind]:
        _cycle(grid, i + 1, sub)
    if p.mode == Mode.NONLINEAR:
        nxt.v -= nxt.rest_v
    interpolate(grid, i)
    grid.levels[i].v += grid.levels[i].e
    jacobi(grid, i, p.post_smoothing)


def vcycle(grid: OracleGrid) -> float:
    """One cycle of the configured type (V unless params.cycle_type says
    otherwise); returns the finest-level residual norm."""
    _cycle(grid, 0, getattr(grid.params, "cycle_type", "V"))
    return comp_residual(grid, 0)


def solve(grid: OracleGrid) -> List[float]:
    """V-cycle loop; returns [initial, res0, res1, ...]
    (reference: src/cpu/CpuSolver.cpp:12-43)."""
    p = grid.params
    initial = comp_residual(grid, 0)
    history = [initial]
    for _ in range(p.maxiter):
        res = vcycle(grid)
        history.append(res)
        if res <= initial / (1.0 / p.tol):
            break
    return history


def comp_f(grid: OracleGrid) -> float:
    """Newton residual F into level-0 f (reference: src/cpu/NewtonSolver.cpp:48-81)."""
    level = grid.levels[0]
    s = _stencil_sum(grid, level.newton_v, level)
    nvi = level.newton_v[1:-1, 1:-1, 1:-1]
    s = s + grid.params.gamma * nvi * np.exp(nvi)
    F = grid.newton_f[1:-1, 1:-1, 1:-1] - s
    level.f[1:-1, 1:-1, 1:-1] = F
    return float(np.sqrt(np.sum(F * F)))


def find_error(grid: OracleGrid) -> None:
    """Inner Jacobian solve (reference: src/cpu/NewtonSolver.cpp:83-108)."""
    for i in range(1, len(grid.levels) - 1):
        restrict(grid.levels[i - 1].newton_v, grid.levels[i].newton_v)
    p = grid.params
    grid.params = p.replace(maxiter=10, tol=0.1, print_progress=False)
    solve(grid)
    grid.params = p
    grid.levels[0].newton_v += grid.levels[0].v


def newton_solve(grid: OracleGrid) -> List[float]:
    """Outer Newton loop (reference: src/cpu/NewtonSolver.cpp:10-44)."""
    grid.newton_f = grid.levels[0].f.copy()
    initial = comp_f(grid)
    history = [initial]
    for _ in range(grid.params.maxiter):
        comp_f(grid)
        grid.levels[0].v[:] = 0.0
        find_error(grid)
        res = comp_f(grid)
        history.append(res)
        if res <= initial / (1.0 / grid.params.tol):
            break
    return history
