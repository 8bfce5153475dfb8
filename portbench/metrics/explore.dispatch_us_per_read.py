"""The enqueue of the §2b explore program's chunks (DeviceExplorer): microseconds of run_fastq's `explore_dispatch` stage (StageTimes, host
clock) over the measured window, per library read. 0 where the stage
never ran."""


def read(run):
    return 1e6 * run.stage_s.get("explore_dispatch", 0.0) / run.reads
