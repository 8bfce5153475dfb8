"""The junction table from the aggregator's buffer of read columns
(models/aggregate.Aggregator.table: one sort in the BED's order, the
group-by and the reductions by segment): microseconds of the
`pass.rows/drain` span (StageTimes, host clock) over the measured
window, per library read. 0 where the span's parent never ran; nothing
where the program times no such span."""


def read(run):
    if "pass.rows" not in run.stage_s:
        return 0.0
    if "pass.rows/drain" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["pass.rows/drain"] / run.reads
