"""Seconds of ``GraphSession.from_graph`` (host partition and build) on
the benchmark's clock."""


def read(run):
    return run.setup.get("partition_s")
