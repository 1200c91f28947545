"""Quickstart on the PyTorch port: DRONE/SVHM connected components on a
Graph500 Kronecker graph (``examples/quickstart.py`` on the port).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Opens a ``GraphSession`` over a power-law graph partitioned with the
paper's CDBH vertex-cut, runs subgraph-centric CC, and prints the paper's
execution metrics (supersteps / (key,value) messages) next to the
vertex-centric baseline. The session keeps the graph resident on the card
(the CPU with ``--device cpu``) and caches each built runner, so the
repeated query at the end builds nothing. ``main`` returns the counts it
prints and the component labels.
"""
import argparse

import numpy as np

from repro_torch.algos import ConnectedComponents
from repro_torch.core import EngineConfig, partition_metrics
from repro_torch.device import resolve_device
from repro_torch.graphgen import kronecker_graph
from repro_torch.session import GraphSession


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = kronecker_graph(14, seed=7)           # 2^14 vertices, power-law
    print(f"graph: {g.n_vertices} vertices, {g.n_edges} edges")

    sess = GraphSession.from_graph(g, n_parts=16, partitioner="cdbh",
                                   device=dev)
    pm = partition_metrics(sess.pg)
    print("partitioning:", pm)

    labels, sc = sess.query(ConnectedComponents())
    # warm=False: the vertex-centric baseline must run cold — warm="auto"
    # would (soundly) restart it from the already-converged SC labels
    _, vc = sess.query(ConnectedComponents(), warm=False,
                       cfg=EngineConfig(mode="vc"))
    out = sess.pg.collect(labels, fill=-1)
    n_components = len(np.unique(out))
    print(f"components: {n_components}")
    print(f"subgraph-centric: {sc.supersteps} supersteps, "
          f"{sc.total_messages} messages "
          f"(runner built in {sc.compile_time:.2f}s)")
    print(f"vertex-centric  : {vc.supersteps} supersteps, "
          f"{vc.total_messages} messages")
    assert sc.supersteps <= vc.supersteps

    # a repeated query reuses the cached runner: nothing is built
    _, again = sess.query(ConnectedComponents(), warm=False)
    print(f"repeat query    : compile_time={again.compile_time:.0f}s "
          f"(cache hit), wall={again.wall_time*1e3:.0f} ms")
    assert again.compile_time == 0.0
    return dict(n_vertices=g.n_vertices, n_edges=g.n_edges,
                n_parts=pm.n_parts, imbalance=pm.imbalance,
                replication_factor=pm.replication_factor,
                frontier=pm.n_frontier, components=n_components,
                sc_supersteps=sc.supersteps, sc_messages=sc.total_messages,
                vc_supersteps=vc.supersteps, vc_messages=vc.total_messages,
                runner_builds=sess.stats.runner_builds, labels=out)


if __name__ == "__main__":
    main()
