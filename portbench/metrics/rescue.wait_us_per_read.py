"""The loop's wait for the 2-mm rescue's host re-calls (models/multihit in the forked worker): microseconds of run_fastq's `slowpath_rescue` stage (StageTimes, host
clock) over the measured window, per library read. 0 where the stage
never ran."""


def read(run):
    return 1e6 * run.stage_s.get("slowpath_rescue", 0.0) / run.reads
