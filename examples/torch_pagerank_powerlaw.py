"""PageRank (paper §7.2, asynchronous accumulative) on a power-law graph on
the PyTorch port, comparing the paper's DRONE-VC against the DRONE-EC
baseline — one ``GraphSession`` per partitioning (sessions are bound to one
partitioned graph; the two cuts are two different graphs on the device)
(``examples/pagerank_powerlaw.py`` on the port).

    PYTHONPATH=src python examples/torch_pagerank_powerlaw.py
    PYTHONPATH=src python examples/torch_pagerank_powerlaw.py --device cpu

``main`` returns, per partitioner, the counts it prints and the ranks.
"""
import argparse

import numpy as np

from repro_torch.algos import PageRank
from repro_torch.core import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.graphgen import powerlaw_graph
from repro_torch.session import GraphSession


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = powerlaw_graph(30_000, alpha=2.2, avg_degree=12, seed=11)
    cfg = EngineConfig(mode="sc", max_local_iters=200)
    pr = PageRank(tol=1e-8)
    rows = {}
    for name, part in (("DRONE-VC (cdbh)", "cdbh"),
                       ("DRONE-EC (rh)", "rh-ec")):
        sess = GraphSession.from_graph(g, 16, part, cfg=cfg, device=dev)
        res, st = sess.query(pr, {"n_vertices": g.n_vertices})
        ranks = sess.pg.collect(res, fill=0.0)
        top = np.argsort(-ranks)[:5]
        rows[part] = dict(supersteps=st.supersteps,
                          messages=st.total_messages, top5=top.tolist(),
                          ranks=ranks)
        print(f"{name:18s} supersteps={st.supersteps:4d} "
              f"messages={st.total_messages:9d} time={st.wall_time:.2f}s "
              f"top5={top.tolist()}")
    # both cuts converge to the same ranks (within the async tolerance)
    a, b = rows["cdbh"]["ranks"], rows["rh-ec"]["ranks"]
    assert np.allclose(a, b, atol=5e-5), float(np.abs(a - b).max())
    mass = float(a.sum())
    print("rank agreement OK; mass =", mass)
    rows["mass"] = mass
    return rows


if __name__ == "__main__":
    main()
