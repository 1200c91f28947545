"""SSSP on a large-diameter road-network proxy (paper §8 USARoad study) on
the PyTorch port: subgraph-centric local fixed points vs one-hop
vertex-centric supersteps, with a locality-preserving partition
(``examples/sssp_road.py`` on the port).

    PYTHONPATH=src python examples/torch_sssp_road.py
    PYTHONPATH=src python examples/torch_sssp_road.py --device cpu

``main`` returns, per mode, the counts it prints and the distances.
"""
import argparse

import numpy as np

from repro_torch.algos import SSSP
from repro_torch.core import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.graphgen import grid_graph
from repro_torch.session import GraphSession


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = grid_graph(120, weighted=True, seed=9)   # 14.4k vertices, diam ~240
    sess = GraphSession.from_graph(g, 16, "range", device=dev)
    rows = {}
    for name, mode in (("DRONE-VC sc", "sc"), ("DRONE-VC vc-mode", "vc")):
        res, st = sess.query(SSSP(), {"source": 0}, warm=False,
                             cfg=EngineConfig(mode=mode,
                                              max_supersteps=50_000))
        dist = sess.pg.collect(res, fill=np.float32(np.inf))
        max_dist = float(np.nanmax(np.where(np.isfinite(dist), dist,
                                            np.nan)))
        print(f"{name:18s} supersteps={st.supersteps:5d} "
              f"messages={st.total_messages:9d} "
              f"max_dist={max_dist:.1f}")
        rows[mode] = dict(supersteps=st.supersteps,
                          messages=st.total_messages, max_dist=max_dist,
                          dist=dist)
    return rows


if __name__ == "__main__":
    main()
