"""The 2-mm rescue's host re-calls as computed
(models/multihit.call_reads_multi_batch in the forked worker, or inline
where the worker is gone): microseconds of the counter
`slowpath_rescue/worker_us` of models/stream.run_fastq over the measured
window, per library read; beside `rescue.wait_us_per_read`, the loop's
wait for them. 0 where `slowpath_rescue` never ran; nothing where the
program keeps no such counter."""


def read(run):
    if "slowpath_rescue" not in run.stage_n:
        return 0.0
    if "slowpath_rescue/worker_us" not in run.stage_n:
        return None
    return run.stage_n["slowpath_rescue/worker_us"] / run.reads
