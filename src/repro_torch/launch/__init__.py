"""Launchers of the port: ``launch.train``, the LM training driver;
``launch.dryrun_graph``, the graph engine's capacity dry run on fake
tensors in a fake world of ranks (``launch.mesh`` builds the production
meshes, ``launch.fake_stats`` counts what the ops move and hold), and
``launch.roofline`` over its records on the H100's constants. The JAX
package's LM dry run (``launch/dryrun.py``, ``launch/specs.py``) has no
counterpart yet."""
