"""The final junction table: microseconds of the harness's `pass.rows`
span (Aggregator.rows, which drains the batched summaries into the
junction table and builds the named rows, and the --filter stack where
the configuration has it; host clock) over the measured window, per
library read."""


def read(run):
    return 1e6 * run.stage_s.get("pass.rows", 0.0) / run.reads
