"""Milliseconds a call spends copying its result to the host: the
program's ``drone.session.fetch`` spans over the traced window's calls."""
from gbench.harness.spans import spans_of, total_s


def read(run):
    t = spans_of(run)
    if t is None:
        return None
    return 1e3 * total_s(t, "drone.session.fetch") / len(run.calls)
