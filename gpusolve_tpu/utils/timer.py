"""Named aggregating phase timers (reference: src/Timer.{h,cpp}).

The reference prints, per V-cycle, ``Took Xms`` plus named counters such as
``sumBuffer: Yms (Nx)`` and ``compile: Zms (Mx)`` (src/Timer.cpp:13-27,
instrumentation sites src/sycl/SyclSolver.cpp:288,373 and sycl-gtx
handler.h:64-67).  On an accelerator, accurate phase timing requires
``jax.block_until_ready`` at the stop edge; use sparingly (each block is a
pipeline bubble) — the solve loop only reads the per-cycle norm.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import jax


class Timer:
    """Aggregating named counters, printed as ``name: Xms (Nx)``."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextmanager
    def section(self, name: str, block_on=None):
        """Time a section; if ``block_on`` is given, ``block_until_ready`` it
        before stopping the clock so async dispatch doesn't hide the cost."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    def suffix(self) -> str:
        """The counter suffix the reference appends to each ``Took Xms`` line
        (src/Timer.cpp:17-24); counters reset after printing."""
        parts = []
        for name, total in self._totals.items():
            parts.append(
                f", {name}: {int(total * 1000)}ms ({self._counts[name]}x)"
            )
        self._totals.clear()
        self._counts.clear()
        return "".join(parts)
