"""The §2b explore program's kernels against their roofline, in percent:
the least time the H100 needs for the profiled passes' explore work (its
K1's variant rows and extras, the reads, the candidates' windows and the
result rows; portbench/yardstick/bounds.py) over the device time of
every activity under the explore labels. Nothing where no such activity
ran."""


def read(run):
    if run.profile is None or run.profile["device_s"]["explore"] <= 0:
        return None
    return (100.0 * run.bounds["explore_s"]
            / run.profile["device_s"]["explore"])
