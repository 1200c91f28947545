"""Host microseconds to issue one batched sweep of every partition: the
mean duration of the program's ``drone.engine.sweep`` spans (no host read
lies inside one) in the traced window."""
from gbench.harness.spans import count, spans_of, total_s


def read(run):
    t = spans_of(run)
    if t is None:
        return None
    n = count(t, "drone.engine.sweep")
    return 1e6 * total_s(t, "drone.engine.sweep") / n if n else None
