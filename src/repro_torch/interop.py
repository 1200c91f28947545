"""Carry host state from the JAX package's objects into the port's.

The port imports nothing of the JAX package, so these functions take plain
numpy data: a dict of a reference ``PartitionedGraph``'s fields (for example
``dataclasses.asdict``-style ``{f.name: getattr(pg, f.name)}``), a
reference warm block, or a reference LM's parameter pytree. Tests use them
to run the port's engine on exactly the partitioned graph the reference
ran on, independently of partitioner parity, and the port's LM on the
reference's weights (``jax.random`` draws cannot be reproduced in torch).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.api import VertexProgram, numpy_dtype
from repro_torch.core.subgraph import PartitionedGraph
from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

__all__ = ["model_params_from_numpy", "partitioned_graph_from_arrays",
           "warm_block_from_numpy"]

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


def _flat(tree: Mapping, prefix: str):
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            yield from _flat(leaf, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", leaf


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: numpy has no bfloat16
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def model_params_from_numpy(tree: Mapping, cfg: ModelConfig, *,
                            device: DeviceLike = None) -> Model:
    """A port ``Model`` holding the weights of the reference's
    ``init_model(key, cfg)`` pytree, given as numpy arrays: blocks stacked
    on a leading repeat axis per scan group, ``tree["blocks"][group][pos]``
    (repeat ``r`` of position ``i`` of group ``g`` is the port's layer
    ``offset(g) + r * len(pattern) + i``: Jamba's full config is one group
    of 8 positions repeated, its smoke config 8 groups of 1); the
    encoder's blocks stacked the same way in one group of one position,
    ``tree["encoder"][0]`` (repeat ``r`` is the port's ``encoder.{r}``).
    The MoE, MLA, MTP, Mamba, mLSTM, sLSTM, cross-attention, ``enc_norm``
    and ``frontend_adapter`` leaves go by the same names (an MoE router
    and its bias, a Mamba's ``A_log`` and ``D``, an mLSTM's ``wi`` and
    ``wf`` and an sLSTM's ``b`` stay float32); a block without an MLP has
    no ``norm2`` or ``mlp``. Every leaf must land on a parameter of the
    same shape and every parameter must get one."""
    model = Model(cfg, device=device)
    stacked = ("blocks", "encoder")
    state = dict(_flat({k: v for k, v in tree.items() if k not in stacked},
                       ""))

    def unstack(group: Mapping, prefix: str, r: int):
        for name, leaf in _flat(group, prefix):
            state[name] = np.asarray(leaf)[r]

    layer = 0
    for gi, (pattern, n_rep) in enumerate(cfg.scan_groups()):
        for r in range(n_rep):
            for i in range(len(pattern)):
                unstack(tree["blocks"][gi][i], f"blocks.{layer}.", r)
                layer += 1
    layer = 0
    for group in tree.get("encoder", ()):
        _, first = next(_flat(group, ""))
        for r in range(len(first)):
            unstack(group, f"encoder.{layer}.", r)
            layer += 1
    model.load_state_dict({k: _tensor(v) for k, v in state.items()},
                          strict=True)
    return model
