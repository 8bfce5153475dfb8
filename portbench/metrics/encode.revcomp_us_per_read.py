"""A paired library's host reverse complement of mate 2 after encoding
(models/stream.run_fastq, `revcomp_batch` under `--pe`): microseconds of
the `encode/revcomp` span (StageTimes, host clock) over the measured
window, per library read, every mate counted. 0 where each pass read one
file (`stream_start` once a pass: a single-end library, nothing to
flip); nothing where a paired pass ran and the program times no such
span."""


def read(run):
    if "encode/revcomp" in run.stage_s:
        return 1e6 * run.stage_s["encode/revcomp"] / run.reads
    if run.stage_n.get("stream_start", 0) <= run.passes:
        return 0.0
    return None
