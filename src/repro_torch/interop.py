"""Carry host state from the JAX package's objects into the port's.

The port imports nothing of the JAX package, so these functions take plain
numpy data: a dict of a reference ``PartitionedGraph``'s fields (for example
``dataclasses.asdict``-style ``{f.name: getattr(pg, f.name)}``) or a
reference warm block. Tests use them to run the port's engine on exactly
the partitioned graph the reference ran on, independently of partitioner
parity.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.api import VertexProgram, numpy_dtype
from repro_torch.core.subgraph import PartitionedGraph

__all__ = ["partitioned_graph_from_arrays", "warm_block_from_numpy"]

_NUMPY_FIELDS = ("gvid", "vmask", "esrc", "edst", "ew", "emask", "slot",
                 "is_frontier", "out_deg", "in_deg", "is_master",
                 "frontier_gvid")


def partitioned_graph_from_arrays(d: Mapping) -> PartitionedGraph:
    """A port ``PartitionedGraph`` from the reference's fields. Array fields
    are copied as numpy arrays with their dtypes; layouts are not carried
    (the port builds its own, bit-identical ones on first use)."""
    kw = {}
    for f in dataclasses.fields(PartitionedGraph):
        if f.name == "edge_layouts" or f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NUMPY_FIELDS or f.name in ("edge_part", "vlabel"):
            v = None if v is None else np.array(v, copy=True)
        else:
            v = int(v)
        kw[f.name] = v
    return PartitionedGraph(**kw)


def warm_block_from_numpy(program: VertexProgram, pg: PartitionedGraph,
                          block) -> np.ndarray:
    """A [P, v_max, K] warm block (a reference ``_warm_block`` or a
    session's remembered result) checked against ``pg`` and cast to the
    program dtype, ready for ``make_sim_runner(warm_start=True)``."""
    blk = np.asarray(block)
    if blk.ndim == 2:
        blk = blk[..., None]
    want = (pg.n_parts, pg.v_max, program.payload)
    if blk.shape != want:
        raise ValueError(f"warm block has shape {blk.shape}, expected {want}")
    return np.ascontiguousarray(blk.astype(numpy_dtype(program.dtype)))
