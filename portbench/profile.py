"""The device side of a traced run, read from torch.profiler: which
activities ran on the card, under which program's labels their host
calls were made, how long the card was busy, and what the host was
doing in the card's longest idle gaps.

The labels are the program's own `record_function` ranges (detect:
read_anchors, k1_exact, k1_fallback, k1_classic, detect_core; explore:
explore_k1, explore_pairs) and the stages of `run_fastq`'s StageTimes,
which the harness opens as ranges named `stage.<name>` while it profiles
(`LabelledTimes`). An activity belongs to the innermost label around the
host call that enqueued it (matched by correlation id, as
`chip_smoke.label_split` matches them).
"""

from __future__ import annotations

import contextlib

from find_circ2_tpu_torch.utils.profiling import StageTimes

PROGRAMS = {
    "detect": ("read_anchors", "k1_exact", "k1_fallback", "k1_classic",
               "detect_core"),
    "explore": ("explore_k1", "explore_pairs"),
}
LABELS = {name: prog for prog, names in PROGRAMS.items() for name in names}
STAGE = "stage."
TOP = 10


class LabelledTimes(StageTimes):
    """StageTimes whose every stage is also a profiler range
    `stage.<name>`, so the trace can say what the host was doing."""

    @contextlib.contextmanager
    def stage(self, name: str):
        from torch.profiler import record_function
        with record_function(STAGE + name), super().stage(name):
            yield


def device_events(prof) -> list:
    """The profile's device activities (kernels, copies, fills), without
    the device-side spans the profiler draws for labels."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in LABELS and not e.name.startswith(STAGE)]


def _merge(spans):
    """Sorted disjoint intervals covering `spans`."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ranges, t):
    """Name of the shortest range holding t, or None."""
    best = None
    for lo, hi, name in ranges:
        if lo <= t <= hi and (best is None or hi - lo < best[0]):
            best = (hi - lo, name)
    return None if best is None else best[1]


def digest(prof, window_s: float) -> dict:
    """Device seconds by program (`device_s`: detect, explore, other),
    busy seconds (union of activity intervals), the window's seconds, the
    activities that took most time by name (`device_ops`) and the longest
    idle gaps by the innermost stage range around their midpoint
    (`idle_gaps`), each a list of at most TOP [name, seconds]."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    dev = device_events(prof)
    labels = [(e.time_range.start, e.time_range.end, LABELS[e.name])
              for e in events if e.device_type == cpu and e.name in LABELS]
    stages = [(e.time_range.start, e.time_range.end, e.name[len(STAGE):])
              for e in events
              if e.device_type == cpu and e.name.startswith(STAGE)]
    enqueued = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    device_s = {"detect": 0.0, "explore": 0.0, "other": 0.0}
    by_name: dict = {}
    for e in dev:
        s = (e.time_range.end - e.time_range.start) / 1e6
        t = enqueued.get(e.id)
        prog = _innermost(labels, t) if t is not None else None
        device_s[prog or "other"] += s
        by_name[e.name] = by_name.get(e.name, 0.0) + s
    busy = _merge((e.time_range.start, e.time_range.end) for e in dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        name = _innermost(stages, (a + b) / 2) or "untimed"
        gaps.append([name, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(device_s=device_s, busy_s=busy_s, window_s=window_s,
                activities=len(dev),
                device_ops=[[n, s] for n, s in ops], idle_gaps=gaps[:TOP])
