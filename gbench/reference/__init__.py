"""Plain PyTorch references of the benchmark's queries.

They read only the benchmark's own edge list (``harness.graphs.EdgeList``
tensors) and import nothing of the program under test."""
