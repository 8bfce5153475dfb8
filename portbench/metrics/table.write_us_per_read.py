"""The output writers: microseconds of the harness's `pass.write` span
(io/bed.write_bed and the stats lines, written under TMPDIR; host clock)
over the measured window, per library read."""


def read(run):
    return 1e6 * run.stage_s.get("pass.write", 0.0) / run.reads
