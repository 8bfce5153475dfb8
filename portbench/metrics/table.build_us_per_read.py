"""The loop of models/aggregate.Aggregator.rows that builds one JunctionRow
a junction, and the junction counts: microseconds of the
`pass.rows/build` span (StageTimes, host clock) over the measured
window, per library read. 0 where the span's parent never ran; nothing
where the program times no such span."""


def read(run):
    if "pass.rows" not in run.stage_s:
        return 0.0
    if "pass.rows/build" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["pass.rows/build"] / run.reads
