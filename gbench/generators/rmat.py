"""Graph500's Kronecker graph (spec v3), sampled on the device.

R-MAT with the configuration's ``a``, ``b``, ``c`` (Graph500: 0.57, 0.19,
0.19; d = 1 - a - b - c) picks each of ``scale`` bits of an edge's two
endpoints; ``edge_factor * 2**scale`` edges are drawn, the vertex labels
permuted (so degree does not follow the id), self-loops and duplicates
dropped, the rest undirected, each with a weight uniform in
``[w_low, w_high)`` (Graph500's SSSP draws them in [0, 1)). It follows the
program's own numpy sampler (``repro_torch/graphgen/kronecker.py``) in
torch on the device: a bit is set where a uniform draw exceeds the
quadrant's share."""
from __future__ import annotations

import torch

from gbench.harness.graphs import EdgeList, generator, undirected


def generate(cfg: dict, seed: int, device) -> EdgeList:
    scale = int(cfg["scale"])
    n = 1 << scale
    m = int(cfg["edge_factor"]) * n
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    gen = generator(device, seed, "rmat")
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thr = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thr
        src |= ii.to(torch.int64) << bit
        dst |= jj.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gen, device=device)
    w_low, w_high = cfg["weights"]
    return undirected(n, perm[src], perm[dst], w_low, w_high, gen)
