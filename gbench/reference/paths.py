"""Shortest paths and BFS levels by Bellman-Ford relaxation, plain PyTorch.

``relax`` iterates ``d[v] = min(d[v], min_{(u, v)} d[u] + w(u, v))`` over
every directed edge until nothing changes. With non-negative weights its
fixed point is unique: for each vertex the least, over all walks from a
key, of the walk's weights added left to right in the value dtype. So any
correct min-plus engine that adds in the same dtype returns it bit for bit,
whatever order it relaxes in; float32 is the program's precision.

Lanes are keys: ``d`` is ``[n_vertices, K]``, lane ``k`` starts at 0 on
``keys[k]`` and at ``inf`` elsewhere. Lanes are relaxed in blocks of
``LANE_BLOCK`` so that the ``[n_edges, lanes]`` message buffer fits.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

__all__ = ["relax", "shortest_paths", "bfs_levels"]

INF = float("inf")
LANE_BLOCK = 16


def relax(src: torch.Tensor, dst: torch.Tensor, w: Optional[torch.Tensor],
          n_vertices: int, keys: torch.Tensor, *,
          dtype: torch.dtype = torch.float32,
          max_rounds: Optional[int] = None) -> torch.Tensor:
    """``[n_vertices, len(keys)]`` values of the min-plus fixed point from
    each key, computed in ``dtype`` (``w=None``: every edge costs 1).
    ``max_rounds`` stops after that many relaxation rounds (a truncated
    search; ``None`` runs to the fixed point)."""
    keys = keys.to(src.device, torch.int64)
    blocks = []
    for k0 in range(0, keys.shape[0], LANE_BLOCK):
        blocks.append(_relax_block(src, dst, w, n_vertices,
                                   keys[k0:k0 + LANE_BLOCK], dtype,
                                   max_rounds))
    return torch.cat(blocks, dim=1)


def _relax_block(src, dst, w, n, keys, dtype, max_rounds):
    K = keys.shape[0]
    d = torch.full((n, K), INF, dtype=dtype, device=src.device)
    d[keys, torch.arange(K, device=src.device)] = 0
    cost = (torch.ones((), dtype=dtype, device=src.device) if w is None
            else w.to(dtype)[:, None])
    rounds = 0
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*index_reduce.*")
        while max_rounds is None or rounds < max_rounds:
            msgs = d.index_select(0, src) + cost
            before, d = d, d.index_reduce(0, dst, msgs, "amin",
                                          include_self=True)
            rounds += 1
            if torch.equal(d, before):
                break
    return d


def shortest_paths(src, dst, w, n_vertices, keys, **kw) -> torch.Tensor:
    """Single-source shortest-path distances from each key (one lane each)."""
    return relax(src, dst, w, n_vertices, keys, **kw)


def bfs_levels(src, dst, n_vertices, keys, **kw) -> torch.Tensor:
    """Breadth-first levels from each key (one lane each); ``inf`` where a
    key does not reach."""
    return relax(src, dst, None, n_vertices, keys, **kw)
