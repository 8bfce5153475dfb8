"""Share of the window's library reads that the streaming loop handed to
the §2b explore program, counted by the loop where it routes them (the
counter `explore_dispatch/reads` of models/stream.run_fastq), in
percent. 0 where `explore_dispatch` never ran; nothing where the
program keeps no such counter."""


def read(run):
    if "explore_dispatch" not in run.stage_n:
        return 0.0
    if "explore_dispatch/reads" not in run.stage_n:
        return None
    return 100.0 * run.stage_n["explore_dispatch/reads"] / run.reads
