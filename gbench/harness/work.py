"""The bytes a semiring edge product needs, counted from the work the
edges ask for and not from any layout that carries them.

A call sweeps partition ``p`` ``sweeps[p]`` times; the partition holds
``edges[p]`` real directed edges and ``vertices[p]`` real vertex copies,
and the call carries ``lanes`` values a vertex, 4 bytes each. Tile and
window padding, padded rows and re-reads are never counted, so the count
stays put when a later change moves the layout.

- ``product_bytes``: the whole product ``y = A (x) x``: each edge's source
  and destination ids (4 B each) and its weight where the program reads
  one (4 B), each vertex's values read once and written once.
- ``combine_bytes``: the reduce-by-destination alone, as
  ``segment_combine_windowed`` is given it: one message of ``lanes``
  values and one destination row (4 B) an edge read, each vertex's values
  written once.
"""
from __future__ import annotations

from typing import Sequence

__all__ = ["product_bytes", "combine_bytes"]

ID = VALUE = 4


def product_bytes(sweeps: Sequence[int], edges: Sequence[int],
                  vertices: Sequence[int], lanes: int,
                  weighted: bool) -> int:
    per_edge = 2 * ID + (VALUE if weighted else 0)
    per_vertex = 2 * lanes * VALUE
    return sum(int(s) * (int(e) * per_edge + int(v) * per_vertex)
               for s, e, v in zip(sweeps, edges, vertices, strict=True))


def combine_bytes(sweeps: Sequence[int], edges: Sequence[int],
                  vertices: Sequence[int], lanes: int) -> int:
    per_edge = lanes * VALUE + ID
    per_vertex = lanes * VALUE
    return sum(int(s) * (int(e) * per_edge + int(v) * per_vertex)
               for s, e, v in zip(sweeps, edges, vertices, strict=True))
