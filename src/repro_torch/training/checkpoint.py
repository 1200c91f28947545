"""Atomic ``.npz`` checkpoints of the port's training state: the port of the
JAX package's ``training/checkpoint.py``, in its file format.

The file format is ``repro_torch.npz_io``'s (the reference's), so the
reference's ``load_pytree(path)`` reads a port file's leaves and meta.
Keys follow the port's own tree, their parts joined by ``|``: a mapping's
keys, a named tuple's field names and an ``nn.Module``'s ``state_dict``
names. A ``TrainState`` is thus
``params|<name>``, ``opt|step``, ``opt|m|<name>`` and ``opt|v|<name>``.
bfloat16 leaves are stored as float32 (numpy has no bfloat16; the cast is
exact) and come back in the dtype of the ``like`` tree's leaf. Writes are
atomic (``npz_io.save_flat``).
"""
from __future__ import annotations

import os
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.npz_io import load_flat, save_flat

_SEP = "|"


def _leaves(tree: Any, path: tuple = ()):
    """(key, leaf) pairs of ``tree`` (modules, mappings and named tuples
    of tensors) in its order."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield _SEP.join(path + (name,)), t
    elif isinstance(tree, Mapping):
        for k in tree:
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), path + (k,))
    else:
        yield _SEP.join(path), tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, *,
                extra_meta: Optional[dict] = None) -> str:
    """Atomically write ``tree``'s leaves to ``path`` with ``extra_meta``
    in the manifest."""
    return save_flat(path, {k: _numpy(v) for k, v in _leaves(tree)},
                     extra_meta)


@torch.no_grad()
def load_pytree(path: str, like: Any = None):
    """Read a checkpoint. Without ``like``: (``{key: numpy array}``,
    meta). With ``like`` (the tree that was saved, or one of the same
    structure): its tensors take the saved values in place, each cast to
    its own dtype on its own device; returns (``like``, meta). The keys and
    shapes must match exactly."""
    flat, meta = load_flat(path)
    if like is None:
        return flat, meta
    want = dict(_leaves(like))
    if sorted(want) != sorted(flat):
        missing = sorted(set(want) - set(flat))[:5]
        extra = sorted(set(flat) - set(want))[:5]
        raise ValueError(f"checkpoint {path} does not match the tree: "
                         f"missing {missing}, unexpected {extra}")
    for key, leaf in want.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape},"
                             f" the tree's {tuple(leaf.shape)}")
        leaf.copy_(torch.from_numpy(np.array(arr)))
    return like, meta


def _numbered(ckpt_dir: str, prefix: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)\.npz", f)
        if m:
            out.append((int(m.group(1)), f))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str, prefix: str = "step_") -> Optional[str]:
    """The path of the highest-numbered ``<prefix><n>.npz``, or None."""
    files = _numbered(ckpt_dir, prefix)
    return os.path.join(ckpt_dir, files[-1][1]) if files else None


def keep_last(ckpt_dir: str, n: int, prefix: str = "step_") -> None:
    """Retention: delete all but the newest ``n`` checkpoints."""
    for _, f in _numbered(ckpt_dir, prefix)[:-n]:
        os.unlink(os.path.join(ckpt_dir, f))
