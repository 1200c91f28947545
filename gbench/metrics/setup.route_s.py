"""Seconds of the partitioner's or router's call inside
``GraphSession.from_graph``, on the program's own clock
(``SessionStats.setup_seconds['route']``, as ``route_s`` in the run's
set-up)."""


def read(run):
    return run.setup.get("route_s")
