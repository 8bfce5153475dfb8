"""The host side of the detect program's launches
(models/pipeline.dispatch_packed's call of detect_batch_packed_fast, or
the sharded engine's rows): microseconds of the `device_dispatch/launch`
span (StageTimes, host clock) over the measured window, per library
read. 0 where the span's parent never ran; nothing where the program
times no such span."""


def read(run):
    if "device_dispatch" not in run.stage_s:
        return 0.0
    if "device_dispatch/launch" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["device_dispatch/launch"] / run.reads
