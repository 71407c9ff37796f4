"""Grid level hierarchy and analytic right-hand-side initialisation.

Data model replacing the reference's ``CpuGridData``/``SyclGridData``
(reference: src/cpu/CpuGridData.{h,cpp}, src/sycl/SyclGridData.{h,cpp}): each
multigrid level is a set of padded, device-resident ``jnp`` arrays of static
shape ``(nx+2, ny+2, nz+2)`` (1-cell halo on every face holding the Dirichlet
boundary).  The whole hierarchy is a pytree (``GridState``) so it flows through
``jax.jit`` / ``shard_map`` unchanged.

Layout: axis order (x, y, z) with z contiguous (the minor dimension).  The
reference's two backends already disagree on layout (z-fastest
Vector3.cpp:16 vs x-fastest SyclBuffer.h:16-29); layout is free as long as the
math matches.

Level hierarchy (reference: src/cpu/CpuGridData.cpp:19-42):
  * ``maxlevel = floor(log2(min(dims))) + 1``
  * each coarser level integer-halves every dim
  * per-level mesh width ``h = 1/(levelDim_y + 1)``

Analytic RHS (the boundary-zero device convention of
src/sycl/SyclGridData.cpp:49-104, equivalent on the interior to the CPU fill
src/cpu/CpuGridData.cpp:45-78):
  * linear mode:    f(x,y,z) = -(f2(x)f0(y)f0(z) + f0(x)f2(y)f0(z)
                                 + f0(x)f0(y)f2(z)),  f0(t)=100 t^4 (t-1)^4,
                    evaluated at x=(i-1)h for padded interior index i
  * nonlinear/Newton: f = 2((y-y²)(z-z²)+(x-x²)(z-z²)+(x-x²)(y-y²))
                        + γ (x-x²)(y-y²)(z-z²) e^{(x-x²)(y-y²)(z-z²)},
                    evaluated at x=i·h for padded interior index i
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpusolve_tpu.config import GridParams, Mode


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def alloc_shape(dims) -> tuple:
    """Aligned allocation shape for a level with interior ``dims``.

    The logical padded extent is ``n+2`` per axis (1-cell Dirichlet halo);
    allocation rounds x,y up to 8 (so GSPMD shardings divide evenly for
    power-of-two meshes) and z up to 128.  No kernel needs the z rounding
    any more; whether dropping it pays on the device is an open measurement
    (ROADMAP).  Cells outside the logical padded region are zero forever.
    """
    nx, ny, nz = dims
    return (_round_up(nx + 2, 8), _round_up(ny + 2, 8), _round_up(nz + 2, 128))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridLevel:
    """One multigrid level's padded field arrays.

    Field roles (reference: src/cpu/CpuGridData.h):
      v        current solution / correction
      f        right-hand side (residual restricted from the finer level,
               below the finest)
      r        residual scratch
      e        interpolated coarse-grid correction (absent on the coarsest
               level, reference: src/cpu/CpuGridData.cpp:37-39)
      rest_v   FAS: restriction of the finer level's v (nonlinear mode only)
      newton_v frozen Newton linearisation point (Newton mode only)
    """

    v: jax.Array
    f: jax.Array
    r: jax.Array
    e: Optional[jax.Array] = None
    rest_v: Optional[jax.Array] = None
    newton_v: Optional[jax.Array] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridState:
    """The full level hierarchy plus Newton's saved original RHS.

    ``newton_f`` is the immutable copy of the finest-level RHS that the outer
    Newton iteration measures its residual against (reference:
    src/cpu/NewtonSolver.cpp:10-12, src/sycl/SyclGridData.cpp:106-115).
    """

    levels: Tuple[GridLevel, ...]
    newton_f: Optional[jax.Array] = None


def _f0(t: np.ndarray) -> np.ndarray:
    """100·t⁴(t−1)⁴ (reference: src/cpu/CpuGridData.cpp:7-9)."""
    return 100.0 * (t * (t - 1.0)) ** 4


def _f2(t: np.ndarray) -> np.ndarray:
    """Second derivative of f0 (reference: src/cpu/CpuGridData.cpp:10-12)."""
    return 100.0 * 4.0 * (t - 1.0) * (t - 1.0) * t * t * (
        14.0 * t * t - 14.0 * t + 3.0
    )


def linear_rhs(dims: Tuple[int, int, int], h: float) -> np.ndarray:
    """Padded RHS cube for the linear Poisson problem, float64 on host.

    Interior padded index i corresponds to coordinate (i-1)·h; the halo is 0
    (reference: src/sycl/SyclGridData.cpp:57-78).
    """
    nx, ny, nz = dims
    out = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    x = (np.arange(1, nx + 1, dtype=np.float64) - 1.0) * h
    y = (np.arange(1, ny + 1, dtype=np.float64) - 1.0) * h
    z = (np.arange(1, nz + 1, dtype=np.float64) - 1.0) * h
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    out[1:-1, 1:-1, 1:-1] = -(
        _f2(X) * _f0(Y) * _f0(Z)
        + _f0(X) * _f2(Y) * _f0(Z)
        + _f0(X) * _f0(Y) * _f2(Z)
    )
    return out


def nonlinear_rhs(
    dims: Tuple[int, int, int], h: float, gamma: float
) -> np.ndarray:
    """Padded RHS cube for ``-Δu + γ·u·e^u = f``, float64 on host.

    Interior padded index i corresponds to coordinate i·h; the halo is 0
    (reference: src/sycl/SyclGridData.cpp:79-103; the exact solution is
    u = (x-x²)(y-y²)(z-z²), see plotter.py:7-8).
    """
    nx, ny, nz = dims
    out = np.zeros((nx + 2, ny + 2, nz + 2), dtype=np.float64)
    x = np.arange(1, nx + 1, dtype=np.float64) * h
    y = np.arange(1, ny + 1, dtype=np.float64) * h
    z = np.arange(1, nz + 1, dtype=np.float64) * h
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    gx = X - X * X
    gy = Y - Y * Y
    gz = Z - Z * Z
    prod = gx * gy * gz
    out[1:-1, 1:-1, 1:-1] = (
        2.0 * (gy * gz + gx * gz + gx * gy) + gamma * prod * np.exp(prod)
    )
    return out


def _device_rhs(params: GridParams, dtype) -> jax.Array:
    """RHS computed on-device (jit) — the analogue of the reference's
    ``init_f_lin``/``init_f`` device kernels (src/sycl/SyclGridData.cpp:49-104).
    Avoids shipping a grid-sized host array to the device; at 513³ that is a
    ~540 MB transfer."""
    nx, ny, nz = params.grid_dim
    h = params.h
    gamma = params.gamma
    linear = params.mode == Mode.LINEAR

    @functools.partial(jax.jit, static_argnums=())
    def build() -> jax.Array:
        off = -1.0 if linear else 0.0
        x = ((jnp.arange(1, nx + 1, dtype=dtype) + off) * h)[:, None, None]
        y = ((jnp.arange(1, ny + 1, dtype=dtype) + off) * h)[None, :, None]
        z = ((jnp.arange(1, nz + 1, dtype=dtype) + off) * h)[None, None, :]
        if linear:
            def f0(t):
                return 100.0 * (t * (t - 1.0)) ** 4

            def f2(t):
                return (
                    100.0 * 4.0 * (t - 1.0) * (t - 1.0) * t * t
                    * (14.0 * t * t - 14.0 * t + 3.0)
                )

            interior = -(
                f2(x) * f0(y) * f0(z)
                + f0(x) * f2(y) * f0(z)
                + f0(x) * f0(y) * f2(z)
            )
        else:
            gx, gy, gz = x - x * x, y - y * y, z - z * z
            prod = gx * gy * gz
            interior = (
                2.0 * (gy * gz + gx * gz + gx * gy)
                + gamma * prod * jnp.exp(prod)
            )
        ax, ay, az = alloc_shape(params.grid_dim)
        return jnp.pad(
            interior, ((1, ax - nx - 1), (1, ay - ny - 1), (1, az - nz - 1))
        )

    return build()


def build_grid(params: GridParams, device=None) -> GridState:
    """Allocate the level hierarchy and fill the finest-level RHS.

    Unlike the reference, fields that a mode never touches are not allocated
    (``rest_v`` only for FAS, ``newton_v`` only for Newton) — they would be
    dead HBM.  ``e`` is absent on the coarsest level, matching
    src/cpu/CpuGridData.cpp:37-39.
    """
    dtype = jnp.dtype(params.dtype)
    dims = params.level_dims()
    nlev = params.num_levels

    def put(arr_np: np.ndarray) -> jax.Array:
        # Convert on host first so only dtype-sized bytes cross to the device.
        arr = jnp.asarray(np.asarray(arr_np, dtype=dtype))
        if device is not None:
            arr = jax.device_put(arr, device)
        return arr

    levels = []
    for i, (nx, ny, nz) in enumerate(dims):
        shape = alloc_shape((nx, ny, nz))

        def zeros() -> jax.Array:
            # Allocate on-device: zero fields must not cost a host→device
            # transfer (the analogue of the reference's device-side
            # clear/clearAll kernels, src/sycl/SyclGridData.cpp:119-145).
            z = jnp.zeros(shape, dtype=dtype)
            return jax.device_put(z, device) if device is not None else z

        if i == 0:
            if dtype == jnp.float64:
                # Host float64 path: bit-exact vs the float64 test oracle.
                if params.mode == Mode.LINEAR:
                    f_np = linear_rhs(dims[0], params.h)
                else:
                    f_np = nonlinear_rhs(dims[0], params.h, params.gamma)
                full = np.zeros(shape, dtype=np.float64)
                full[: nx + 2, : ny + 2, : nz + 2] = f_np
                f = put(full)
            else:
                f = _device_rhs(params, dtype)
                if device is not None:
                    f = jax.device_put(f, device)
        else:
            f = zeros()
        levels.append(
            GridLevel(
                v=zeros(),
                f=f,
                r=zeros(),
                e=zeros() if i + 1 != nlev else None,
                rest_v=zeros() if params.mode == Mode.NONLINEAR else None,
                newton_v=zeros() if params.mode == Mode.NEWTON else None,
            )
        )

    newton_f = levels[0].f if params.mode == Mode.NEWTON else None
    return GridState(levels=tuple(levels), newton_f=newton_f)
