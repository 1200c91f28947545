"""LDBC Graphalytics' EVPS: for every call the window finished,
(|V| + |E|) times its lanes, summed, divided by the window's seconds on the
host's clock. As in Graphalytics' data sets, |V| counts the vertices that
have an edge (a Kronecker graph leaves many isolated) and |E| each
undirected edge once."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    per_lane = run.n_touched + run.n_undirected
    return sum(c.lanes for c in run.calls) * per_lane / run.window_s
