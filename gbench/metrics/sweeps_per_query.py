"""Partition sweeps a call: the sum of ``ExecutionStats.partition_sweeps``,
averaged over the window's calls."""


def read(run):
    sweeps = [sum(c.sweeps) for c in run.calls if c.sweeps is not None]
    if not sweeps:
        return None
    return sum(sweeps) / len(sweeps)
