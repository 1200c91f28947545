"""Where a rank sits on a device mesh, for the ``shard_map`` backend.

The JAX package's ``shard_map`` backend is driven by one controller over a
``Mesh``; the port runs SPMD instead: every rank of a
``torch.distributed`` job runs the same program on its own block of the
graph. The caller creates the process group (NCCL on the card, gloo on the
CPU) and a ``DeviceMesh`` with ``mesh_dim_names``; ``EngineConfig``'s
``subgraph_axes`` and ``edge_axes`` name its dimensions, as they name the
JAX mesh's axes.

A rank's block, as ``P(sub_axes, edge_axes)`` hands it out in the
reference:

  - partition ``part`` = its coordinate over the subgraph axes, linearized
    row-major in the order ``subgraph_axes`` lists them;
  - edge shard ``shard`` = its coordinate over the edge axes, linearized
    the same way: edge columns ``[shard * Se, (shard + 1) * Se)`` of the
    partition, ``Se = e_max / n_edge``.

Mesh axes named in neither tuple replicate the work, as an axis a
``PartitionSpec`` does not name does in the reference.

``placement`` builds the process groups once per (mesh, axes) with
``torch.distributed.new_group`` over explicit rank lists: the subgraph
group of a rank holds the ranks that share its coordinates on every other
axis (one rank per partition), the edge group the ranks of its partition
(one per shard). ``new_group`` is collective over the whole job, so every
rank builds every group in the same order.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Any, Sequence, Tuple

import numpy as np

__all__ = ["MeshPlacement", "mesh_group", "placement"]

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class MeshPlacement:
    """One rank's block of the mesh and the groups it talks over."""
    part: int                 # partition this rank computes
    shard: int                # its edge shard within the partition
    n_sub: int                # partitions (the subgraph axes' size)
    n_edge: int               # edge shards per partition
    sub_group: Any            # process group over the subgraph axes
    edge_group: Any           # over the edge axes; None when n_edge == 1
    mesh_group: Any           # every rank of the mesh
    root: int                 # global rank at the mesh's first coordinate
    sub_parts: Tuple[int, ...]  # partition of each sub_group rank, in the
                                # group's rank order (ascending global rank)


def _dims(mesh, axes: Sequence[str]) -> Tuple[int, ...]:
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh axes {missing} are not dimensions of the "
                         f"mesh {names}")
    return tuple(names.index(a) for a in axes)


def _axes_size(mesh, axes: Sequence[str]) -> int:
    """Product of the sizes of the named mesh dimensions (1 for none)."""
    ranks = np.asarray(mesh.mesh.tolist())
    return int(np.prod([ranks.shape[d] for d in _dims(mesh, axes)])) \
        if axes else 1


def _linear(coord: Sequence[int], dims: Sequence[int], shape) -> int:
    """Row-major index of ``coord`` over ``dims`` in the listed order."""
    i = 0
    for d in dims:
        i = i * shape[d] + coord[d]
    return i


def _groups(ranks: np.ndarray, dims: Tuple[int, ...], me: int):
    """Create one group per setting of the dimensions outside ``dims`` (in
    row-major order, on every rank) and return the one holding ``me``."""
    import torch.distributed as dist
    other = [d for d in range(ranks.ndim) if d not in dims]
    mine = None
    for fixed in itertools.product(*[range(ranks.shape[d]) for d in other]):
        idx = [slice(None)] * ranks.ndim
        for d, c in zip(other, fixed):
            idx[d] = c
        members = sorted(int(r) for r in ranks[tuple(idx)].reshape(-1))
        g = dist.new_group(members)
        if me in members:
            mine = g
    return mine


def mesh_group(mesh) -> Tuple[Any, int]:
    """``(group, root)``: the process group over every rank of ``mesh``
    (None, the default group, when the mesh spans the whole job) and the
    global rank at the mesh's first coordinate. Built on first use and
    cached per mesh, like ``placement``."""
    import torch.distributed as dist
    per_mesh = _CACHE.setdefault(mesh, {})
    got = per_mesh.get("mesh")
    if got is None:
        ranks = np.asarray(mesh.mesh.tolist(), dtype=np.int64).reshape(-1)
        every = sorted(int(r) for r in ranks)
        group = None if every == list(range(dist.get_world_size())) \
            else dist.new_group(every)
        got = per_mesh["mesh"] = (group, int(ranks[0]))
    return got


def placement(mesh, subgraph_axes: Sequence[str],
              edge_axes: Sequence[str] = ()) -> MeshPlacement:
    """This rank's ``MeshPlacement`` on ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``); built on first use and cached per mesh and axes.
    Every rank of the job must make its first call for a given (mesh,
    axes) at the same point of its program."""
    import torch.distributed as dist
    key = (tuple(subgraph_axes), tuple(edge_axes))
    per_mesh = _CACHE.setdefault(mesh, {})
    pl = per_mesh.get(key)
    if pl is not None:
        return pl
    sub_d, edge_d = _dims(mesh, subgraph_axes), _dims(mesh, edge_axes)
    if set(sub_d) & set(edge_d):
        raise ValueError(f"subgraph_axes {tuple(subgraph_axes)} and "
                         f"edge_axes {tuple(edge_axes)} share an axis")
    ranks = np.asarray(mesh.mesh.tolist(), dtype=np.int64)
    me = dist.get_rank()
    where = np.argwhere(ranks == me)
    if where.shape[0] != 1:
        raise ValueError(f"rank {me} is not on the mesh {ranks.tolist()}")
    coord = tuple(int(c) for c in where[0])
    shape = ranks.shape
    n_sub = _axes_size(mesh, subgraph_axes)
    n_edge = _axes_size(mesh, edge_axes)
    every_group, root = mesh_group(mesh)
    sub_group = _groups(ranks, sub_d, me)
    edge_group = _groups(ranks, edge_d, me) if n_edge > 1 else None
    members = sorted(int(r) for r in dist.get_process_group_ranks(sub_group))
    sub_parts = tuple(
        _linear(tuple(int(c) for c in np.argwhere(ranks == r)[0]), sub_d,
                shape) for r in members)
    pl = MeshPlacement(
        part=_linear(coord, sub_d, shape), shard=_linear(coord, edge_d, shape),
        n_sub=n_sub, n_edge=n_edge, sub_group=sub_group,
        edge_group=edge_group, mesh_group=every_group, root=root,
        sub_parts=sub_parts)
    per_mesh[key] = pl
    return pl
