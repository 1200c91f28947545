"""Share of the traced window in which the card is idle while the host is
in the engine's run: idle gaps that overlap the program's
``drone.engine.run`` spans, by interval overlap."""
from gbench.harness.spans import idle_overlap_s, spans_of


def read(run):
    t = spans_of(run)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * idle_overlap_s(t, ("drone.engine.run",)) / t.window_s
