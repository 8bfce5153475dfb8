"""The streaming loop's start and stop around each pass
(models/stream.run_fastq: the DeviceExplorer, the rescue worker's fork
and ping, and the worker's close): microseconds of the `stream_start`
and `stream_stop` stages (StageTimes, host clock) over the measured
window, per library read. Nothing where the program times neither."""


def read(run):
    keys = [k for k in ("stream_start", "stream_stop") if k in run.stage_s]
    if not keys:
        return None
    return 1e6 * sum(run.stage_s[k] for k in keys) / run.reads
