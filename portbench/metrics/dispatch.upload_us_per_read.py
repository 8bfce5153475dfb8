"""The host-to-device copies of each detect batch (the reads, lengths and
reverse complements, with their from_numpy and ascontiguousarray):
microseconds of the `device_dispatch/upload` span (StageTimes, host
clock) over the measured window, per library read. 0 where the span's
parent never ran; nothing where the program times no such span."""


def read(run):
    if "device_dispatch" not in run.stage_s:
        return 0.0
    if "device_dispatch/upload" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["device_dispatch/upload"] / run.reads
