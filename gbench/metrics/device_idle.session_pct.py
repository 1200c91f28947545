"""Share of the traced window in which the card is idle while the host is
inside ``GraphSession.query`` but not in the engine's run: idle gaps that
overlap the program's ``drone.query`` spans and no ``drone.engine.run``
span, by interval overlap."""
from gbench.harness.spans import idle_overlap_s, spans_of


def read(run):
    t = spans_of(run)
    if t is None or t.window_s <= 0:
        return None
    idle = idle_overlap_s(t, ("drone.query",), ("drone.engine.run",))
    return 100.0 * idle / t.window_s
