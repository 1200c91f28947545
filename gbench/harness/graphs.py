"""The benchmark's own edge list, made on the device from the seed.

A generator under ``gbench/generators/<name>.py`` (the configuration's
``"generator"``) returns undirected edges, each once, with its weight;
``EdgeList`` holds them in both directions, as the program and the
reference both read them."""
from __future__ import annotations

import dataclasses
import hashlib

import torch

__all__ = ["EdgeList", "subseed", "undirected", "generator"]


def subseed(seed: int, name: str) -> int:
    """A 63-bit seed for one purpose (``name``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(device, seed: int, name: str) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, name))
    return gen


@dataclasses.dataclass
class EdgeList:
    """An undirected graph as directed edges both ways: ``src``/``dst``
    int64 ``[2 m]`` and float32 ``w`` on the device; the edge ``(lo[i],
    hi[i])`` of the ``m`` undirected ones is row ``i`` and row ``m + i``,
    with one weight."""
    n_vertices: int
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor

    @property
    def n_undirected(self) -> int:
        return self.src.shape[0] // 2

    @property
    def n_directed(self) -> int:
        return self.src.shape[0]

    def degrees(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.n_vertices)

    def to_host(self):
        """``(src, dst, w)`` as numpy arrays, for the program's ``Graph``."""
        return (self.src.cpu().numpy(), self.dst.cpu().numpy(),
                self.w.cpu().numpy())


def undirected(n: int, a: torch.Tensor, b: torch.Tensor,
               w_low: float, w_high: float,
               gen: torch.Generator) -> EdgeList:
    """The simple undirected graph of the pairs ``(a, b)``: self-loops
    dropped, each unordered pair once (ascending by ``lo * n + hi``), one
    weight each drawn uniform in ``[w_low, w_high)``, then both
    directions."""
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    keep = lo != hi
    key = torch.unique(lo[keep] * n + hi[keep])
    lo, hi = key // n, key % n
    w = torch.rand(key.shape[0], generator=gen, device=key.device,
                   dtype=torch.float32)
    w = w * float(w_high - w_low) + float(w_low)
    return EdgeList(n, torch.cat([lo, hi]), torch.cat([hi, lo]),
                    torch.cat([w, w]))
