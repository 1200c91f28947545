"""Launchers of the port: ``launch.train``, the LM training driver;
``launch.dryrun``, the LM dry run (every arch x shape x mesh cell on
DTensors over fake tensors, ``launch.specs`` its inputs), and
``launch.dryrun_graph``, the graph engine's capacity dry run, both in a
fake world of ranks (``launch.mesh`` builds the production meshes,
``launch.fake_stats`` counts what the ops move and hold); and
``launch.roofline`` over their records on the H100's constants."""
