"""Host milliseconds a call spends in ``GraphSession.query`` outside the
engine's run and the result's copy to the host: the self time of the
program's ``drone.query`` span less its ``drone.engine.run`` and
``drone.session.fetch`` spans, over the traced window's calls."""
from gbench.harness.spans import self_s, spans_of


def read(run):
    t = spans_of(run)
    if t is None:
        return None
    host = self_s(t, "drone.query", ("drone.engine.run",
                                     "drone.session.fetch"))
    return 1e3 * host / len(run.calls)
