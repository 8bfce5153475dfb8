"""The enqueue of each detect batch's readback (models/pipeline.HostCopy:
the pinned buffer, the non-blocking copy and its event): microseconds of
the `device_dispatch/readback` span (StageTimes, host clock) over the
measured window, per library read. 0 where the span's parent never ran;
nothing where the program times no such span."""


def read(run):
    if "device_dispatch" not in run.stage_s:
        return 0.0
    if "device_dispatch/readback" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["device_dispatch/readback"] / run.reads
