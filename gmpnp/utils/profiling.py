"""Phase timers and JAX profiler hooks.

Replaces the reference's per-step wall-clock prints
(3D/MPNP_CO2ER_pore.py:857) with proper phase accounting
(build/compile/execute) and optional XLA trace capture of device runs.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulating wall-clock phase timer.

        t = PhaseTimer()
        with t.phase("assembly"):
            ...
        print(t.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {tot:9.3f} s  ({n} calls, "
                         f"{tot / max(n, 1) * 1e3:8.2f} ms/call)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """Capture a device trace via jax.profiler when a logdir is given
    (no-op otherwise) — inspect with TensorBoard or xprof."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
