"""Seconds from process start to the first timed call: the graph made on
the device, its partition and upload, the kernels built or loaded, the
layouts, and one warm-up call."""


def read(run):
    return run.setup["setup_s"]
