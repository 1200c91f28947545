"""Graph generators, one module per configuration ``"generator"``; each
has ``generate(cfg, seed, device) -> harness.graphs.EdgeList``."""
