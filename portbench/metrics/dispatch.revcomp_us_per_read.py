"""The host reverse complement of each detect batch
(models/pipeline.revcomp_batch in _to_device, or the sharded engine's):
microseconds of the `device_dispatch/revcomp` span (StageTimes, host
clock) over the measured window, per library read. 0 where the span's
parent never ran; nothing where the program times no such span."""


def read(run):
    if "device_dispatch" not in run.stage_s:
        return 0.0
    if "device_dispatch/revcomp" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["device_dispatch/revcomp"] / run.reads
