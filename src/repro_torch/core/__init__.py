from repro_torch.core.api import DeviceSubgraph, SemiringSweep, VertexProgram
from repro_torch.core.engine import (EdgeCombine, EngineConfig,
                                     make_bsp_runner, make_sim_runner,
                                     normalize_edge_backend,
                                     resolve_edge_backend, run, run_shard_map,
                                     run_sim)
from repro_torch.core.graph import Graph
from repro_torch.core.layouts import EdgeLayouts, TileBlock, WindowBlock
from repro_torch.core.metrics import (ExecutionStats, PartitionMetrics,
                                      partition_metrics)
from repro_torch.core.partition import PARTITIONERS, STREAM_ROUTERS
from repro_torch.core.subgraph import (PartitionedGraph, ShapePolicy,
                                       assemble_partitioned_graph,
                                       build_partitioned_graph,
                                       frontier_election)

__all__ = [
    "DeviceSubgraph", "SemiringSweep", "VertexProgram", "EdgeCombine",
    "EngineConfig", "run", "run_sim", "run_shard_map", "make_sim_runner",
    "make_bsp_runner",
    "resolve_edge_backend", "normalize_edge_backend", "EdgeLayouts",
    "TileBlock", "WindowBlock", "Graph", "ExecutionStats",
    "PartitionMetrics", "partition_metrics", "PARTITIONERS",
    "STREAM_ROUTERS", "PartitionedGraph", "ShapePolicy",
    "build_partitioned_graph", "assemble_partitioned_graph",
    "frontier_election", "partition_and_build",
]


def partition_and_build(g: Graph, n_parts: int, partitioner: str = "cdbh",
                        *, seed: int = 0, pad_multiple: int = 8):
    """One-call preprocessing: partition edges + build the padded arrays
    (exact padding). Pairs with the one-shot ``run_sim``; for repeated
    queries open a ``repro_torch.session.GraphSession``."""
    part = PARTITIONERS[partitioner](g, n_parts, seed=seed)
    return build_partitioned_graph(g, part, n_parts, pad_multiple=pad_multiple)
