"""Device-mesh construction for 3-D domain decomposition.

Replaces the reference's device discovery (src/sycl/ContextHandles.h:7-44,
which enumerates OpenCL platforms and picks the last GPU) with
``jax.devices()`` + a 3-D ``jax.sharding.Mesh`` whose axes ('x','y','z')
partition the grid's spatial axes.  The cards of one host are joined all to
all (NVLink), so the mesh follows the decomposition alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

AXES = ("x", "y", "z")


def factor_devices(n: int) -> Tuple[int, int, int]:
    """Factor ``n`` devices into a balanced 3-D mesh shape.

    Greedy: distribute prime factors (largest first) onto the axis with the
    smallest current extent, so 8 → (2,2,2), 4 → (2,2,1), 6 → (3,2,1).
    """
    factors = []
    m = n
    p = 2
    while m > 1:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1 if p == 2 else 2
        if p * p > m and m > 1:
            factors.append(m)
            break
    shape = [1, 1, 1]
    for fct in sorted(factors, reverse=True):
        shape[int(np.argmin(shape))] *= fct
    return tuple(sorted(shape, reverse=True))


def make_mesh(
    shape: Optional[Tuple[int, int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 3-D mesh over ``devices`` (default: all visible devices)."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = factor_devices(len(devices))
    n = shape[0] * shape[1] * shape[2]
    if n > len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {len(devices)}"
        )
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, AXES)
