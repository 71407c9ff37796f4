"""gpusolve_tpu — a 3D geometric-multigrid solver framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``Bricktricker/gpu-solve`` (C++17 CPU/OpenMP + SYCL application): it solves the
3D Poisson equation and the nonlinear variant ``-Δu + γ·u·e^u = f`` on a
structured grid with a user-supplied 7-point stencil, using geometric multigrid
V-cycles in three modes — linear MG, nonlinear FAS MG, and Newton-multigrid
(reference: src/main.cpp:88-111, src/cpu/CpuSolver.cpp, src/cpu/NewtonSolver.cpp).

Design (a redesign, not a port):
  * Grid levels are padded device-resident ``jnp`` arrays organized as a pytree;
    the level hierarchy is built at trace time so every level has static shapes.
  * All hot ops (fused damped-Jacobi smoothing, residual, FAS stencil apply,
    full-weighting restriction, trilinear prolongation, squared-norm reduction)
    are `jnp` slice arithmetic that XLA fuses into loop kernels.
  * The whole V-cycle is a single jitted computation; the once-per-cycle
    residual norm is the only host sync (same async profile as the reference
    GPU backend, src/sycl/SyclSolver.cpp:86-162).
  * Multi-device scaling is 3-D spatial domain decomposition over a
    ``jax.sharding.Mesh`` — the distribution layer the reference never had.
"""

from gpusolve_tpu.config import (
    Mode,
    Stencil,
    GridParams,
    parse_config,
    parse_config_text,
)
from gpusolve_tpu.grid import GridLevel, GridState, build_grid
from gpusolve_tpu.solver.vcycle import solve, vcycle
from gpusolve_tpu.solver.newton import newton_solve
from gpusolve_tpu.solver.refine import solve_refine

__version__ = "0.1.0"

__all__ = [
    "Mode",
    "Stencil",
    "GridParams",
    "parse_config",
    "parse_config_text",
    "GridLevel",
    "GridState",
    "build_grid",
    "solve",
    "vcycle",
    "newton_solve",
    "solve_refine",
]
