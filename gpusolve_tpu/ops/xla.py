"""The multigrid kernels as plain `jnp` slice arithmetic.

Static-shape slice arithmetic over padded arrays; XLA fuses each op into
loop fusions on the device.  The test-suite oracle (tests/oracle.py)
matches the reference C++ loop nest semantics.

Array model: a field with interior dims ``(nx, ny, nz)`` lives in an array of
*allocated* shape ``>= (nx+2, ny+2, nz+2)`` — a one-cell Dirichlet halo plus
optional alignment padding (see gpusolve_tpu.grid.alloc_shape).
Every cell outside the interior is always zero; ops preserve that invariant.
Logical interior dims are passed explicitly (``dims``) — never inferred from
the array shape.

Numerics implemented (reference file:line cited per function):
  * 7-point stencil application ÷ h²      (src/cpu/CpuSolver.cpp:56-61)
  * residual + mode term + L2 norm        (src/cpu/CpuSolver.cpp:45-83)
  * fused damped-Jacobi sweeps            (src/cpu/CpuSolver.cpp:141-179)
  * FAS nonlinear operator apply          (src/cpu/CpuSolver.cpp:182-209)
  * 27-point full-weighting restriction   (src/cpu/CpuSolver.cpp:211-238)
  * 4-pass trilinear interpolation        (src/cpu/CpuSolver.cpp:240-290)

All mode branching is resolved at trace time (as the reference bakes the
mode into generated kernel source host-side,
src/sycl/SyclSolver.cpp:182-196).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from gpusolve_tpu.config import GridParams, Mode, Stencil

Array = jax.Array
Dims = Tuple[int, int, int]


def _interior(a: Array, dims: Dims) -> Array:
    nx, ny, nz = dims
    return a[1 : 1 + nx, 1 : 1 + ny, 1 : 1 + nz]


def _set_interior(a: Array, dims: Dims, val: Array) -> Array:
    nx, ny, nz = dims
    return a.at[1 : 1 + nx, 1 : 1 + ny, 1 : 1 + nz].set(val)


def _pad_to(interior: Array, dims: Dims, shape) -> Array:
    """Embed an interior-shaped result into a zeroed alloc-shaped array."""
    nx, ny, nz = dims
    return jnp.pad(
        interior,
        (
            (1, shape[0] - nx - 1),
            (1, shape[1] - ny - 1),
            (1, shape[2] - nz - 1),
        ),
    )


def stencil_apply(
    v: Array, dims: Dims, stencil: Stencil, inv_h2: float
) -> Array:
    """Σᵢ sᵢ·v[x+oxᵢ, y+oyᵢ, z+ozᵢ] / h² over the interior.

    Returns the unpadded interior result.  The tap loop is unrolled at trace
    time over the (static) config-driven stencil, like the reference unrolls
    it host-side into generated source (src/sycl/SyclSolver.cpp:219-223).
    """
    nx, ny, nz = dims
    acc = None
    for val, (ox, oy, oz) in zip(stencil.values, stencil.offsets):
        tap = jax.lax.slice(
            v,
            (1 + ox, 1 + oy, 1 + oz),
            (1 + ox + nx, 1 + oy + ny, 1 + oz + nz),
        )
        term = val * tap
        acc = term if acc is None else acc + term
    return acc * inv_h2


def _mode_residual_term(
    params: GridParams, v_int: Array, newton_v_int: Optional[Array]
) -> Array:
    """The nonlinear term added to A·v/h² in the residual.

    NEWTON: γ·(1+ṽ)·v·e^ṽ with frozen ṽ (src/cpu/CpuSolver.cpp:63-66);
    NONLINEAR: γ·v·e^v (src/cpu/CpuSolver.cpp:67-72, tutorial formula 6.13).
    """
    if params.mode == Mode.NEWTON:
        ex = jnp.exp(newton_v_int)
        return params.gamma * (1.0 + newton_v_int) * v_int * ex
    if params.mode == Mode.NONLINEAR:
        return params.gamma * v_int * jnp.exp(v_int)
    return jnp.zeros_like(v_int)


def residual(
    v: Array,
    f: Array,
    dims: Dims,
    params: GridParams,
    h: float,
    newton_v: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Residual field and its squared L2 norm over the interior.

    Returns ``(r, sumsq)`` where ``r`` is zero outside the interior (the
    reference only ever writes interior r, src/cpu/CpuSolver.cpp:74-77) and
    ``sumsq = Σ r²`` (the caller takes the sqrt, matching
    src/cpu/CpuSolver.cpp:82).
    """
    inv_h2 = 1.0 / (h * h)
    v_int = _interior(v, dims)
    av = stencil_apply(v, dims, params.stencil, inv_h2)
    if params.mode != Mode.LINEAR:
        av = av + _mode_residual_term(
            params,
            v_int,
            _interior(newton_v, dims) if newton_v is not None else None,
        )
    r_int = _interior(f, dims) - av
    r = _pad_to(r_int, dims, v.shape)
    sumsq = jnp.sum(r_int * r_int)
    return r, sumsq


def jacobi(
    v: Array,
    f: Array,
    dims: Dims,
    params: GridParams,
    h: float,
    n_iter: int,
    newton_v: Optional[Array] = None,
) -> Array:
    """``n_iter`` fused damped-Jacobi sweeps; returns the updated v.

    Reference semantics (src/cpu/CpuSolver.cpp:141-179): each sweep computes
    the full residual with the *current* v (simultaneous update — true Jacobi)
    then updates
      linear:    v += ω · (h²/s₀) · r                       (:157-158)
      nonlinear: v += ω · r / (s₀/h² + γ(1+v)e^v)           (:159-165)
      Newton:    v += ω · r / (s₀/h² + γ(1+ṽ)e^ṽ), ṽ frozen (:166-172)
    The reference materialises r in a separate pass; here residual + update
    fuse into one read of (v, f) and one write of v per sweep — parity is in
    the math, not the pass structure.  The sweep loop is unrolled at trace
    time (n_iter is a small static config value).
    """
    v = jnp.asarray(v)
    inv_h2 = 1.0 / (h * h)
    pre_fac = params.stencil.diag / (h * h)
    alpha = (h * h) / params.stencil.diag  # reference: CpuSolver.cpp:144-145
    nv_int = _interior(newton_v, dims) if newton_v is not None else None

    for _ in range(n_iter):
        v_int = _interior(v, dims)
        av = stencil_apply(v, dims, params.stencil, inv_h2)
        if params.mode == Mode.LINEAR:
            r_int = _interior(f, dims) - av
            new_v = v_int + params.omega * (alpha * r_int)
        elif params.mode == Mode.NONLINEAR:
            ex = jnp.exp(v_int)
            r_int = _interior(f, dims) - (av + params.gamma * v_int * ex)
            denom = pre_fac + params.gamma * (1.0 + v_int) * ex
            new_v = v_int + params.omega * (r_int / denom)
        else:  # NEWTON
            ex = jnp.exp(nv_int)
            lin = params.gamma * (1.0 + nv_int) * ex
            r_int = _interior(f, dims) - (av + lin * v_int)
            denom = pre_fac + lin
            new_v = v_int + params.omega * (r_int / denom)
        v = _set_interior(v, dims, new_v)
    return v


def apply_stencil_fas(
    v: Array, dims: Dims, params: GridParams, h: float
) -> Array:
    """FAS coarse-operator application: A(v)/h² + γ·v·e^v over the interior,
    zero outside (reference: src/cpu/CpuSolver.cpp:182-209, only used in
    nonlinear mode)."""
    inv_h2 = 1.0 / (h * h)
    v_int = _interior(v, dims)
    av = stencil_apply(v, dims, params.stencil, inv_h2)
    result = av + params.gamma * v_int * jnp.exp(v_int)
    return _pad_to(result, dims, v.shape)


_RESTRICT_W1D = (0.5, 1.0, 0.5)  # per-axis factors (2-|o|)/2, o in {-1,0,1}


def restrict_full_weighting(
    fine: Array,
    fine_dims: Dims,
    coarse_dims: Dims,
    coarse_shape,
) -> Array:
    """27-point full-weighting restriction: coarse[x] ← Σ w·fine[2x+o].

    Weights 0.125·∏((2-|oᵢ|)/2) over oᵢ ∈ {-1,0,1}³ sum to 1 (reference:
    src/cpu/CpuSolver.cpp:211-238).  Writes the coarse interior; zero
    elsewhere.  Implemented as 27 strided slices summed — XLA fuses this into
    one gather pass over the fine grid.
    """
    del fine_dims  # bounds depend only on the coarse dims

    def taps(n_int: int, off: int) -> slice:
        # fine indices 2x+off for coarse interior x in [1, n_int]
        return slice(2 + off, 2 + off + 2 * n_int - 1, 2)

    cnx, cny, cnz = coarse_dims
    acc = None
    for ii, wx in zip((-1, 0, 1), _RESTRICT_W1D):
        for jj, wy in zip((-1, 0, 1), _RESTRICT_W1D):
            for kk, wz in zip((-1, 0, 1), _RESTRICT_W1D):
                w = 0.125 * wx * wy * wz
                tap = fine[taps(cnx, ii), taps(cny, jj), taps(cnz, kk)]
                term = w * tap
                acc = term if acc is None else acc + term
    return _pad_to(acc, coarse_dims, coarse_shape)


def interpolate(
    coarse: Array,
    coarse_dims: Dims,
    fine_dims: Dims,
    fine_shape,
) -> Array:
    """Trilinear prolongation of coarse v onto a fine-level correction field.

    Mirrors the reference's 4 passes (src/cpu/CpuSolver.cpp:240-290):
    inject coarse values at even fine sites, then midpoint-average along x,
    then y, then z.  Sites the reference never writes stay zero (they are
    derived from the zero Dirichlet halo), so the result is zero outside the
    logical padded region.
    """
    fnx, fny, fnz = fine_dims
    fX, fY, fZ = fnx + 2, fny + 2, fnz + 2
    E = jnp.zeros((fX, fY, fZ), dtype=coarse.dtype)

    # Inject: fine[2i,2j,2k] = coarse[i,j,k] for even sites < dim-1
    # (reference :247-255).
    nx = (fX - 1 + 1) // 2
    ny = (fY - 1 + 1) // 2
    nz = (fZ - 1 + 1) // 2
    E = E.at[0 : fX - 1 : 2, 0 : fY - 1 : 2, 0 : fZ - 1 : 2].set(
        coarse[:nx, :ny, :nz]
    )

    # x-direction midpoints at (odd, even, even) (reference :257-266).
    E = E.at[1 : fX - 1 : 2, 0:fY:2, 0:fZ:2].set(
        0.5 * E[0 : fX - 2 : 2, 0:fY:2, 0:fZ:2]
        + 0.5 * E[2:fX:2, 0:fY:2, 0:fZ:2]
    )
    # y-direction midpoints at (any, odd, even) (reference :268-277).
    E = E.at[:, 1 : fY - 1 : 2, 0:fZ:2].set(
        0.5 * E[:, 0 : fY - 2 : 2, 0:fZ:2] + 0.5 * E[:, 2:fY:2, 0:fZ:2]
    )
    # z-direction midpoints at (any, any, odd) (reference :279-288).
    E = E.at[:, :, 1 : fZ - 1 : 2].set(
        0.5 * E[:, :, 0 : fZ - 2 : 2] + 0.5 * E[:, :, 2:fZ:2]
    )
    return jnp.pad(
        E,
        (
            (0, fine_shape[0] - fX),
            (0, fine_shape[1] - fY),
            (0, fine_shape[2] - fZ),
        ),
    )
