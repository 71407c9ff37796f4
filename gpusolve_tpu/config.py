"""Problem configuration: stencil, grid parameters, config-file parsing.

Mirrors the reference's config surface (reference: src/gridParams.h:7-47 and the
14-line positional config format parsed in src/main.cpp:32-85, documented in
README.md:19-33): maxiter, tol, grid dims, mode (0=linear, 1=nonlinear,
2=Newton), pre/post smoothing counts, omega, gamma, 7 stencil values and their
(x, y, z) offsets, and the derived mesh width ``h = 1/(gridDim_y + 1)``.

Everything here is static (hashable, frozen) so a ``GridParams`` can be closed
over at trace time, as the reference bakes the mode branch into generated
kernel source host-side (src/sycl/SyclSolver.cpp:182-196).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple


class Mode(enum.IntEnum):
    """Solver mode (reference: src/gridParams.h:29-33, config line 6)."""

    LINEAR = 0
    NONLINEAR = 1
    NEWTON = 2


@dataclasses.dataclass(frozen=True)
class Stencil:
    """A 7-point structured-sparse operator template.

    ``values[i]`` multiplies the grid point at relative offset ``offsets[i]``;
    only radius-1 offsets make sense with the 1-cell halo.  ``values[0]`` is
    treated as the diagonal by the smoother (reference: src/gridParams.h:7-26,
    diagonal assumption src/cpu/CpuSolver.cpp:144-145).
    """

    values: Tuple[float, ...]
    offsets: Tuple[Tuple[int, int, int], ...]

    def __post_init__(self) -> None:
        if len(self.values) != len(self.offsets):
            raise ValueError(
                f"stencil has {len(self.values)} values but "
                f"{len(self.offsets)} offsets"
            )
        for off in self.offsets:
            if len(off) != 3:
                raise ValueError(f"stencil offset {off!r} is not 3-D")
            if any(abs(o) > 1 for o in off):
                raise ValueError(
                    f"stencil offset {off!r} exceeds the radius-1 halo"
                )

    @property
    def diag(self) -> float:
        """The diagonal coefficient (assumed at index 0, like the reference)."""
        return self.values[0]

    @staticmethod
    def poisson_7pt() -> "Stencil":
        """The standard 7-point Laplacian used by the example config
        (reference: examples/data-2nd_order.conf:11-14)."""
        return Stencil(
            values=(6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
            offsets=(
                (0, 0, 0),
                (1, 0, 0),
                (-1, 0, 0),
                (0, 1, 0),
                (0, -1, 0),
                (0, 0, 1),
                (0, 0, -1),
            ),
        )


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Full problem description (reference: src/gridParams.h:28-47).

    Frozen + tuple-typed so instances hash — they are passed as static
    arguments to jitted solver functions.
    """

    maxiter: int
    tol: float
    grid_dim: Tuple[int, int, int]
    mode: Mode
    pre_smoothing: int
    post_smoothing: int
    omega: float
    gamma: float
    stencil: Stencil
    print_progress: bool = True
    # Storage dtype (no reference equivalent; the reference is double).
    dtype: str = "float32"  # "float32" | "float64"
    # Multigrid cycling schedule (beyond-reference: the reference only has
    # V-cycles, src/cpu/CpuSolver.cpp:85-139).  "V" recurses once per
    # level, "W" twice, "F" recurses F-then-V (each coarse visit continues
    # from the previous visit's v; every visit restricts afresh and zeroes
    # its own coarser start, so one outer cycle = one stop-test iteration
    # regardless of schedule).
    cycle_type: str = "V"  # "V" | "W" | "F"

    def __post_init__(self) -> None:
        if self.cycle_type not in ("V", "W", "F"):
            raise ValueError(
                f"cycle_type must be 'V', 'W' or 'F', got "
                f"{self.cycle_type!r}"
            )

    @property
    def h(self) -> float:
        """Finest-level mesh width (reference: src/main.cpp:84)."""
        return 1.0 / (self.grid_dim[1] + 1)

    @property
    def num_levels(self) -> int:
        """``floor(log2(min dim)) + 1`` (reference: src/cpu/CpuGridData.cpp:19)."""
        return int(math.floor(math.log(min(self.grid_dim)) / math.log(2.0))) + 1

    def level_dims(self) -> Tuple[Tuple[int, int, int], ...]:
        """Interior dims per level; each coarser level halves every dim
        (reference: src/cpu/CpuGridData.cpp:22-30)."""
        dims = [self.grid_dim]
        for _ in range(1, self.num_levels):
            px, py, pz = dims[-1]
            dims.append((px // 2, py // 2, pz // 2))
        return tuple(dims)

    def level_h(self, level: int) -> float:
        """Mesh width of a level: ``1/(levelDim_y + 1)``
        (reference: src/cpu/CpuGridData.cpp:41)."""
        return 1.0 / (self.level_dims()[level][1] + 1)

    def replace(self, **kw) -> "GridParams":
        return dataclasses.replace(self, **kw)

    @property
    def properly_nested(self) -> bool:
        """True when every coarsening step satisfies fine = 2·coarse+1 per
        axis (grid dims of the form m·2^k-1), which makes coarse grid points
        coincide geometrically with fine ones.  The reference's integer
        halving (src/cpu/CpuGridData.cpp:27-29) silently assumes this — its
        experiments only use 63/127/255 (runExperiments.py:89); other sizes
        (e.g. 96, 257) produce misaligned coarse grids and the V-cycle can
        diverge, in the reference and here alike."""
        ds = self.level_dims()
        return all(
            f == 2 * c + 1
            for fine, coarse in zip(ds, ds[1:])
            for f, c in zip(fine, coarse)
        )


def parse_config_text(text: str, **overrides) -> GridParams:
    """Parse the 14-line whitespace-separated config format.

    Token order (reference: src/main.cpp:32-85): maxiter, tol, dimX, dimY,
    dimZ, mode, preSmoothing, postSmoothing, omega, gamma, 7 stencil values,
    7 x-offsets, 7 y-offsets, 7 z-offsets.  Like the reference's
    ``operator>>`` parsing, tokens are read from a flat whitespace-separated
    stream, so line structure is cosmetic.
    """
    toks = text.split()
    if len(toks) < 10 + 7 * 4:
        raise ValueError(
            f"config has {len(toks)} tokens, expected {10 + 7 * 4}"
        )
    it = iter(toks)

    def nxt(cast):
        return cast(next(it))

    maxiter = nxt(int)
    tol = nxt(float)
    dim = (nxt(int), nxt(int), nxt(int))
    mode_raw = nxt(int)
    try:
        mode = Mode(mode_raw)
    except ValueError:
        raise ValueError(f"Invalid mode {mode_raw} (expected 0, 1 or 2)")
    pre = nxt(int)
    post = nxt(int)
    omega = nxt(float)
    gamma = nxt(float)
    values = tuple(nxt(float) for _ in range(7))
    xoff = [nxt(int) for _ in range(7)]
    yoff = [nxt(int) for _ in range(7)]
    zoff = [nxt(int) for _ in range(7)]
    stencil = Stencil(values=values, offsets=tuple(zip(xoff, yoff, zoff)))

    params = GridParams(
        maxiter=maxiter,
        tol=tol,
        grid_dim=dim,
        mode=mode,
        pre_smoothing=pre,
        post_smoothing=post,
        omega=omega,
        gamma=gamma,
        stencil=stencil,
    )
    if overrides:
        params = params.replace(**overrides)
    return params


def parse_config(path: str, **overrides) -> GridParams:
    """Load a config file in the reference's format (src/main.cpp:32-85)."""
    with open(path, "r") as f:
        return parse_config_text(f.read(), **overrides)
