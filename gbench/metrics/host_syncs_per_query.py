"""Device-to-host synchronisations a call, from ``ExecutionStats.host_syncs``,
averaged over the window's calls."""


def read(run):
    syncs = [c.host_syncs for c in run.calls if c.host_syncs is not None]
    if not syncs:
        return None
    return sum(syncs) / len(syncs)
