from repro_torch.graphgen.kronecker import kronecker_graph, rmat_edges
from repro_torch.graphgen.synthetic import powerlaw_graph, ring_graph, grid_graph, random_graph

__all__ = [
    "kronecker_graph", "rmat_edges", "powerlaw_graph", "ring_graph",
    "grid_graph", "random_graph",
]
