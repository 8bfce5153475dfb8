"""Device microseconds of the detect program per detect batch: every
activity enqueued under its profiler labels (read_anchors, k1_exact,
k1_fallback, k1_classic, detect_core), over the batches of the profiled
passes. Nothing without a profile or a batch."""


def read(run):
    if run.profile is None or not run.bounds["detect_batches"]:
        return None
    return (1e6 * run.profile["device_s"]["detect"]
            / run.bounds["detect_batches"])
