"""Multi-process initialisation.

The reference is strictly single-process (SURVEY.md §2.3: no NCCL/MPI/
anything); ``initialize`` joins the global JAX runtime across processes,
after which ``dist.make_mesh`` spans every global device.

Usage (one call near the top of every process)::

    from gpusolve_tpu.dist import multihost, make_mesh
    multihost.initialize()   # env-driven (JAX_COORDINATOR_ADDRESS, ...)
    mesh = make_mesh()       # all global devices, 3-D axes

On a single process ``initialize`` is a no-op.

CPU smoke path: the same code runs multi-process on CPU backends
(``JAX_PLATFORMS=cpu`` + ``xla_force_host_platform_device_count``), which is
how tests/test_multihost.py exercises the plumbing.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Join the multi-process JAX runtime (SURVEY.md §5 distributed row).

    Arguments default to the standard environment variables
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); no cluster environment is auto-detected.  Returns
    True when a multi-process runtime was (or already had been)
    initialised, False for the single-process no-op case.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if coordinator_address is None and num_processes is None:
        # Plain single-process run.
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def is_multiprocess() -> bool:
    return jax.process_count() > 1
