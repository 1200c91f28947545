"""What a program run on fake tensors would move and hold on a card: the
port's counterpart of the JAX package's ``launch/hlo_stats.py`` and
``launch/hlo_walk.py``, which read XLA's compiled HLO text. PyTorch runs
eagerly and has no such text, so the program is run instead, inside
``torch._subclasses.FakeTensorMode`` (every tensor has its shape, dtype
and device, and no storage), under ``OpCounter``, a ``TorchDispatchMode``
that sees every aten op and records

  - the bytes each op reads and writes, each operand and each result once
    (a view moves nothing): an HBM traffic proxy over every op, where
    ``hlo_walk`` counts only dot operands;
  - matmul FLOPs, ``2 * |out| * contracted`` for ``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``mv`` and ``dot``;
  - the collectives issued, by kind (their payloads are counted where
    they are issued, by the engine's ``sbs.ShardExchange`` and
    ``EdgeCombine``, as ``bytes``);
  - the peak of live bytes: each storage an op creates counts from its
    creation until its Python storage object is collected (a weakref
    finalizer), so tensors that existed before the counter started, the
    program's arguments, are not in it.

Trip counts are the caller's: it runs a loop body as many times as it
wants counted, or windows (``OpCounter.window``) one pass and multiplies.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpCounter"]

_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "mv", "dot")
_COLLECTIVES = {"allreduce_": "all_reduce", "allgather_": "all_gather",
                "_allgather_base_": "all_gather"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _matmul_flops(name: str, args, out: torch.Tensor) -> int:
    """``2 * |out| * k``, ``k`` the contracted length: the last dimension
    of the first matrix operand (``addmm`` / ``baddbmm`` lead with the
    bias)."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2 * out.numel() * int(a.shape[-1])


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module
    docstring): ``hbm_bytes``, ``dot_flops``, ``ops``; ``live`` and
    ``peak`` bytes of the storages the ops created. ``window(name)`` keeps
    the counts of a stretch of the run in ``windows[name]``."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.dot_flops = 0
        self.ops = 0
        self.collective_counts: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.windows: Dict[str, dict] = {}
        self._live: Dict[int, int] = {}      # storage key -> bytes

    def _freed(self, key: int) -> None:
        self.live -= self._live.pop(key)

    def _track(self, t: torch.Tensor, seen: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in seen or key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":       # payloads are counted apart
            name = func.overloadpacket.__name__
            kind = _COLLECTIVES.get(name, name)
            self.collective_counts[kind] = \
                self.collective_counts.get(kind, 0) + 1
            return out
        if func.namespace != "aten":
            return out
        self.ops += 1
        ins = {id(t): t for t in _tensors((args, kwargs))}
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        if not func.is_view:
            self.hbm_bytes += sum(_nbytes(t) for t in ins.values()) \
                + sum(_nbytes(t) for t in outs)
        if name in _MATMULS and outs:
            self.dot_flops += _matmul_flops(name, args, outs[0])
        seen = {t.untyped_storage()._cdata for t in ins.values()}
        for t in outs:
            self._track(t, seen)
        return out

    def counts(self) -> dict:
        return dict(hbm_bytes=self.hbm_bytes, dot_flops=self.dot_flops,
                    ops=self.ops,
                    collective_counts=dict(self.collective_counts))

    @contextlib.contextmanager
    def window(self, name: str) -> Iterator[None]:
        """Record the counts of the ops run inside the block as
        ``windows[name]`` (``hbm_bytes``, ``dot_flops``, ``ops``, and the
        collectives issued by kind, ``collective_counts``)."""
        before = self.counts()
        yield
        after = self.counts()
        cc = after.pop("collective_counts")
        was = before.pop("collective_counts")
        self.windows[name] = {k: after[k] - before[k] for k in after}
        self.windows[name]["collective_counts"] = {
            k: n - was.get(k, 0) for k, n in cc.items() if n > was.get(k, 0)}
