"""Share of the window's library reads that the streaming loop handed to
the §2b explore program (DeviceExplorer.dispatch_arrays, counted by the
harness's wrapper around the call), in percent."""


def read(run):
    return 100.0 * run.routed / run.reads
