"""The streaming loop's enqueue of each detect batch (host reverse complement, copies, launches): microseconds of run_fastq's `device_dispatch` stage (StageTimes, host
clock) over the measured window, per library read. 0 where the stage
never ran."""


def read(run):
    return 1e6 * run.stage_s.get("device_dispatch", 0.0) / run.reads
