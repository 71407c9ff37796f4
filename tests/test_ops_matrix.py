"""Every op of ops/xla.py against the float64 oracle, on aligned allocations.

The matrix spans op × mode × grid shape (cubic, non-cubic and anisotropic,
all properly nested) × storage dtype.  Fields live in ``grid.alloc_shape``
arrays, so the alignment padding beyond the logical halo is exercised too.
float64 must agree with the oracle to rounding (1e-12 relative); float32 to
``F32_RTOL`` of the largest reference value (a 7-tap stencil rounds at ~1e-7
of its largest term).
"""

import numpy as np
import pytest

import oracle as orc
from gpusolve_tpu.config import GridParams, Mode, Stencil
from gpusolve_tpu.grid import alloc_shape
from gpusolve_tpu.ops import xla

SHAPES = [(15, 15, 15), (31, 15, 63), (15, 31, 7), (7, 15, 31)]
DTYPES = ["float64", "float32"]
MODES = [Mode.LINEAR, Mode.NONLINEAR, Mode.NEWTON]
F32_RTOL = 1e-5


def make_params(mode, dims, dtype):
    return GridParams(
        maxiter=1, tol=1e-5, grid_dim=dims, mode=mode, pre_smoothing=3,
        post_smoothing=3, omega=0.8, gamma=1.0,
        stencil=Stencil.poisson_7pt(), dtype=dtype,
    )


def seeded_grid(p, seed):
    """An oracle hierarchy with random interiors on levels 0 and 1."""
    rng = np.random.default_rng(seed)
    g = orc.OracleGrid(p)
    for lvl in g.levels[:2]:
        for a in (lvl.v, lvl.f, lvl.newton_v):
            a[1:-1, 1:-1, 1:-1] = rng.standard_normal(
                a[1:-1, 1:-1, 1:-1].shape
            )
        lvl.newton_v *= 0.3
    return g


def on_device(a, dims, dtype):
    """Embed a logical padded array in its aligned allocation."""
    out = np.zeros(alloc_shape(dims), dtype)
    out[: a.shape[0], : a.shape[1], : a.shape[2]] = a
    return out


def check(got, want, dtype):
    got = np.asarray(got, np.float64)[
        : want.shape[0], : want.shape[1], : want.shape[2]
    ]
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        assert np.max(np.abs(got - want)) <= F32_RTOL * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name.lower())
def test_jacobi_sweep(mode, dims, dtype):
    p = make_params(mode, dims, dtype)
    g = seeded_grid(p, 10)
    lvl = g.levels[0]
    args = [on_device(a, dims, dtype) for a in (lvl.v, lvl.f, lvl.newton_v)]
    got = xla.jacobi(
        args[0], args[1], dims, p, lvl.h, 2,
        newton_v=args[2] if mode == Mode.NEWTON else None,
    )
    orc.jacobi(g, 0, 2)
    check(got, lvl.v, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name.lower())
def test_residual_and_norm(mode, dims, dtype):
    p = make_params(mode, dims, dtype)
    g = seeded_grid(p, 11)
    lvl = g.levels[0]
    args = [on_device(a, dims, dtype) for a in (lvl.v, lvl.f, lvl.newton_v)]
    r, sumsq = xla.residual(
        args[0], args[1], dims, p, lvl.h,
        newton_v=args[2] if mode == Mode.NEWTON else None,
    )
    norm = orc.comp_residual(g, 0)
    check(r, lvl.r, dtype)
    rel = 1e-12 if dtype == "float64" else F32_RTOL
    assert float(np.sqrt(sumsq)) == pytest.approx(norm, rel=rel)
    # Nothing outside the logical interior is written.
    out = np.asarray(r).copy()
    nx, ny, nz = dims
    out[1 : nx + 1, 1 : ny + 1, 1 : nz + 1] = 0.0
    assert not out.any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", SHAPES)
def test_fas_apply(dims, dtype):
    p = make_params(Mode.NONLINEAR, dims, dtype)
    g = seeded_grid(p, 12)
    lvl = g.levels[1]
    got = xla.apply_stencil_fas(
        on_device(lvl.v, lvl.dims, dtype), lvl.dims, p, lvl.h
    )
    orc.apply_stencil(g, 1, lvl.v)
    check(got, lvl.r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", SHAPES)
def test_restriction(dims, dtype):
    p = make_params(Mode.LINEAR, dims, dtype)
    g = seeded_grid(p, 13)
    fine, coarse = g.levels[0], g.levels[1]
    got = xla.restrict_full_weighting(
        on_device(fine.v, fine.dims, dtype), fine.dims, coarse.dims,
        alloc_shape(coarse.dims),
    )
    orc.restrict(fine.v, coarse.f)
    check(got, coarse.f, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", SHAPES)
def test_interpolation(dims, dtype):
    p = make_params(Mode.LINEAR, dims, dtype)
    g = seeded_grid(p, 14)
    fine, coarse = g.levels[0], g.levels[1]
    got = xla.interpolate(
        on_device(coarse.v, coarse.dims, dtype), coarse.dims, fine.dims,
        alloc_shape(fine.dims),
    )
    orc.interpolate(g, 0)
    check(got, fine.e, dtype)
