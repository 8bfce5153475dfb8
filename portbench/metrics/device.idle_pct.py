"""Share of the profiled passes' wall time in which the card ran no
activity, in percent (busy: the union of the activities' intervals in
the torch.profiler trace)."""


def read(run):
    if run.profile is None:
        return None
    p = run.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
