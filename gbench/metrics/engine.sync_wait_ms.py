"""Milliseconds a call's host spends blocked on the card's flag and count
reads: the program's ``drone.engine.sync`` spans over the traced window's
calls."""
from gbench.harness.spans import spans_of, total_s


def read(run):
    t = spans_of(run)
    if t is None:
        return None
    return 1e3 * total_s(t, "drone.engine.sync") / len(run.calls)
