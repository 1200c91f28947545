"""The random geometric graph of the 10th DIMACS Implementation Challenge
collection (``rgg_n_2_X_s0``), made on the device.

``n = 2**scale`` points uniform in the unit square (float64), and an edge
wherever two points lie closer than ``r = radius_factor * sqrt(ln n / n)``
(the collection's 0.55). The square is cut into ``m * m`` cells of side
``1 / m``, ``m = floor(1 / r)``, so every edge joins a cell to itself or to
one of its 8 neighbours. Vertex ids are the points sorted by (cell row
``floor(y * m)``, cell column ``floor(x * m)``), stable in draw order, so ids
follow the plane as a mesh's do. Each pair closer than ``r`` (its float64
distance) is one undirected edge whose weight is that distance in float32:
the collection's graphs are unweighted, and a road graph weighs an arc by
its length."""
from __future__ import annotations

import math

import torch

from gbench.harness.graphs import EdgeList, generator

#: the 9 cell offsets (row, column) a point's neighbours lie in
OFFSETS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]


def radius(n: int, radius_factor: float) -> float:
    return float(radius_factor) * math.sqrt(math.log(n) / n)


def points(cfg: dict, seed: int, device) -> torch.Tensor:
    """``[n, 2]`` float64 (x, y) in draw order."""
    n = 1 << int(cfg["scale"])
    gen = generator(device, seed, "rgg")
    return torch.rand(n, 2, generator=gen, device=device,
                      dtype=torch.float64)


def generate(cfg: dict, seed: int, device) -> EdgeList:
    xy = points(cfg, seed, device)
    n = xy.shape[0]
    r = radius(n, cfg["radius_factor"])
    m = int(math.floor(1.0 / r))
    col = (xy[:, 0] * m).floor().long().clamp_(0, m - 1)
    row = (xy[:, 1] * m).floor().long().clamp_(0, m - 1)
    cell, order = torch.sort(row * m + col, stable=True)   # ids: cell order
    xy, row, col = xy[order], row[order], col[order]
    count = torch.bincount(cell, minlength=m * m)
    start = torch.cumsum(count, 0) - count
    width = int(count.max())
    ids = torch.arange(n, device=device)
    slot = torch.arange(width, device=device)
    lo, hi, w = [], [], []
    for dr, dc in OFFSETS:
        nr, nc = row + dr, col + dc
        inside = (nr >= 0) & (nr < m) & (nc >= 0) & (nc < m)
        ncell = nr.clamp(0, m - 1) * m + nc.clamp(0, m - 1)
        cand = start[ncell][:, None] + slot[None, :]          # [n, width]
        ok = inside[:, None] & (slot[None, :] < count[ncell][:, None])
        cand = torch.where(ok, cand, ids[:, None])
        ok &= cand > ids[:, None]             # each pair once, as (lo, hi)
        d = (xy[cand] - xy[:, None, :]).square().sum(-1).sqrt()
        ok &= d < r
        i, k = torch.nonzero(ok, as_tuple=True)
        lo.append(i)
        hi.append(cand[i, k])
        w.append(d[i, k].to(torch.float32))
    lo, hi, w = torch.cat(lo), torch.cat(hi), torch.cat(w)
    order = torch.argsort(lo * n + hi)
    lo, hi, w = lo[order], hi[order], w[order]
    return EdgeList(n, torch.cat([lo, hi]), torch.cat([hi, lo]),
                    torch.cat([w, w]))
