"""The benchmark's general parts: manifest and file lookup, the graph and
traffic generators' shared pieces, the run of one cell, the trace reader
and the work arithmetic of the roofline metrics."""
