"""Supersteps (exchange rounds) a call, from ``ExecutionStats.supersteps``,
averaged over the window's calls. Beside ``sweeps_per_query`` it parts the
rounds of exchange from the depth of the local phase between them."""


def read(run):
    steps = [c.supersteps for c in run.calls if c.supersteps is not None]
    if not steps:
        return None
    return sum(steps) / len(steps)
