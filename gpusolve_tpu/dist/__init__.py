"""Multi-device 3-D spatial domain decomposition.

The reference is single-process, single-device (SURVEY.md §2.3); this layer
adds distribution: each grid level is block-partitioned over a 3-D
``jax.sharding.Mesh`` of devices.  The
stencil/transfer ops in gpusolve_tpu.ops are written as shifted-slice
arithmetic, so under ``jit`` with sharded operands the XLA SPMD partitioner
inserts the one-cell halo-exchange collective-permutes automatically — the
same traced V-cycle runs on one device or many.

Coarse levels below a per-shard size threshold are explicitly *replicated*
(every device redundantly smooths the tiny coarse grids): the multigrid analogue
of pipeline-stage consolidation, avoiding halo messages larger than the level
itself (SURVEY.md §5 "long-context" note).

The explicit engine (gpusolve_tpu.dist.spmd) replaces the
partitioner-inserted collectives with hand-scheduled ``lax.ppermute`` face
exchanges (6 per stencil application — the roofline minimum) inside
``shard_map``: mesh-aware per-level allocation keeps restriction and
prolongation shard-local given a one-cell ghost, coarse levels consolidate
to a replicated layout with ``all_gather``, and norms reduce with ``psum``.
All three modes (LINEAR/FAS/Newton) run on the explicit engine; residual
sequences match the single-device solver to 1e-10 on the test mesh.  Stencil
applications are overlap-structured (interior from the local block, faces
patched from the ghosts) so the permutes can run concurrently with interior
compute.

Multi-process: gpusolve_tpu.dist.multihost wraps
``jax.distributed.initialize``; bench_multichip.py at the repo root is the
scaling harness.
"""

from gpusolve_tpu.dist.mesh import factor_devices, make_mesh
from gpusolve_tpu.dist.sharding import level_shardings, shard_state
from gpusolve_tpu.dist.spmd import newton_solve_spmd, solve_spmd
from gpusolve_tpu.dist import multihost

__all__ = [
    "factor_devices",
    "make_mesh",
    "level_shardings",
    "shard_state",
    "solve_spmd",
    "newton_solve_spmd",
    "multihost",
]
