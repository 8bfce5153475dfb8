"""The sort and naming of the junction rows (io/bed.renumber): microseconds
of the `pass.rows/renumber` span (StageTimes, host clock) over the
measured window, per library read. 0 where the span's parent never ran;
nothing where the program times no such span."""


def read(run):
    if "pass.rows" not in run.stage_s:
        return 0.0
    if "pass.rows/renumber" not in run.stage_s:
        return None
    return 1e6 * run.stage_s["pass.rows/renumber"] / run.reads
