"""The detect program's kernels against their roofline, in percent: the
least time the H100 needs for the profiled passes' detect work (the
probe's rows of every anchor, the variant rows of the anchors that fall
to the fallback slice or to the classic redo, the reads, the core's
genome windows and the result rows; portbench/yardstick/bounds.py) over
the device time of every activity under the detect labels. Nothing
where no such activity ran."""


def read(run):
    if run.profile is None or run.profile["device_s"]["detect"] <= 0:
        return None
    return 100.0 * run.bounds["detect_s"] / run.profile["device_s"]["detect"]
