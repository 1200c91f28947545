"""Seconds of the session call that built the edge layouts and their
device copy (the warm-up call's), on the program's own clock
(``SessionStats.setup_seconds['layouts']``, as ``layouts_s`` in the run's
set-up)."""


def read(run):
    return run.setup.get("layouts_s")
