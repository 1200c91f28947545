"""Launchers of the port: ``launch.train``, the LM training driver. The
JAX package's other launchers (dry runs, HLO statistics, rooflines, mesh
specs) have no counterpart yet."""
