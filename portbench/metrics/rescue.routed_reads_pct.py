"""Share of the window's library reads that the streaming loop handed to
the 2-mm anchor rescue (models/multihit, in the forked worker or
inline), counted by the loop where it selects them (the counter
`aggregate/rescue_reads` of models/stream._Loop), in percent. 0 where
`slowpath_rescue` never ran; nothing where the program keeps no such
counter."""


def read(run):
    if "slowpath_rescue" not in run.stage_n:
        return 0.0
    if "aggregate/rescue_reads" not in run.stage_n:
        return None
    return 100.0 * run.stage_n["aggregate/rescue_reads"] / run.reads
