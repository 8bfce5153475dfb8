"""The streaming loop's aggregation of each batch's rows: microseconds of run_fastq's `aggregate` stage (StageTimes, host
clock) over the measured window, per library read. 0 where the stage
never ran."""


def read(run):
    return 1e6 * run.stage_s.get("aggregate", 0.0) / run.reads
