"""Paper-native configs: DRONE graph-engine workloads (not an LM arch).

The port's copy of the JAX package's graph workloads, for the graph
examples and benchmarks: ``n_parts`` subgraphs, each one partition of the
vertex-cut (``partitioner``, ``mode``).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkload:
    name: str
    algo: str              # cc | sssp | pagerank | gsim
    scale: int             # kronecker scale (2^scale vertices)
    edge_factor: int = 16
    n_parts: int = 256     # subgraphs (== pod*data of the production mesh)
    partitioner: str = "cdbh"
    mode: str = "sc"


def config():
    return GraphWorkload(name="drone-kron26-cc", algo="cc", scale=26)


def smoke_config():
    return GraphWorkload(name="drone-smoke", algo="cc", scale=10,
                         edge_factor=8, n_parts=4)


WORKLOADS = {
    "cc": GraphWorkload(name="drone-kron26-cc", algo="cc", scale=26),
    "pagerank": GraphWorkload(name="drone-kron26-pr", algo="pagerank", scale=26),
    "sssp": GraphWorkload(name="drone-kron26-sssp", algo="sssp", scale=26),
}
