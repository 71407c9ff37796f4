"""Numerical kernels for the multigrid solver (``ops.xla``: `jnp` slice
arithmetic that XLA fuses)."""

from gpusolve_tpu.ops import xla  # noqa: F401
