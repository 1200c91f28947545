"""Carry host state from the JAX package's objects into the port's.

The port imports nothing of the JAX package, so these functions take plain
numpy data: a dict of a reference ``PartitionedGraph``'s fields (for example
``dataclasses.asdict``-style ``{f.name: getattr(pg, f.name)}``), a
reference warm block, a reference LM's parameter pytree or its training
state. Tests use them to run the port's engine on exactly the partitioned
graph the reference ran on, independently of partitioner parity, and the
port's LM on the reference's weights and moments (``jax.random`` draws
cannot be reproduced in torch).
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
           "train_state_from_numpy", "warm_block_from_numpy"]

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


def _unstacked(tree: Mapping, cfg: ModelConfig) -> dict:
    """``{port state_dict name: numpy leaf}`` of a reference parameter
    pytree (or a tree of the same structure: AdamW's moments), its stacked
    blocks split into the port's layers."""
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
    return state


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
    model.load_state_dict({k: _tensor(v)
                           for k, v in _unstacked(tree, cfg).items()},
                          strict=True)
    return model


def _field(tree, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def train_state_from_numpy(tree, cfg: ModelConfig, *,
                           device: DeviceLike = None):
    """The port's ``TrainState`` from the reference's, given as numpy
    (``jax.tree.map(np.asarray, state)``, or a mapping with the same
    fields): ``params`` through ``model_params_from_numpy``; ``opt.step``
    an int32 scalar; ``opt.m`` and ``opt.v`` unstacked as the parameters
    are, float32, keyed by the port's parameter names. Every moment leaf
    must land on a parameter of the same shape and every parameter must
    get one of each."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.steps import TrainState
    model = model_params_from_numpy(_field(tree, "params"), cfg,
                                    device=device)
    opt = _field(tree, "opt")
    named = dict(model.named_parameters())
    moments = []
    for which in ("m", "v"):
        flat = _unstacked(_field(opt, which), cfg)
        if sorted(flat) != sorted(named):
            raise ValueError(
                f"opt.{which} does not match the model's parameters: "
                f"missing {sorted(set(named) - set(flat))[:5]}, "
                f"unexpected {sorted(set(flat) - set(named))[:5]}")
        out = {}
        for name, p in named.items():
            a = np.asarray(flat[name])
            if a.shape != tuple(p.shape):
                raise ValueError(f"opt.{which} leaf {name} has shape "
                                 f"{a.shape}, the parameter {tuple(p.shape)}")
            out[name] = _tensor(a).to(device=p.device, dtype=torch.float32)
        moments.append(out)
    step = torch.tensor(int(np.asarray(_field(opt, "step"))),
                        dtype=torch.int32, device=model.embed.device)
    return TrainState(params=model,
                      opt=AdamWState(step=step, m=moments[0], v=moments[1]))
