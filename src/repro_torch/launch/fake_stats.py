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
  - the collectives issued, by kind: the process-group ops the graph
    engine issues (``c10d``; their payloads are counted where they are
    issued, by ``sbs.ShardExchange`` and ``EdgeCombine``) and the
    functional collectives DTensor issues (``_c10d_functional``: counted
    with their payload bytes, the tensor the rank contributes, and the
    ring model's wire bytes, from the group's size);
  - the peak of live bytes: each storage an op creates counts from its
    creation until its Python storage object is collected (a weakref
    finalizer), so tensors that existed before the counter started, the
    program's arguments, are not in it.

Under DTensor it counts what one rank does: an op on DTensors is passed
to DTensor (``NotImplemented``), and the local ops it runs come back
through the counter on the rank's shards. The shape inference of
DTensor's sharding propagation, which runs the op once at the global
shapes (and only on the first call of each schema), is not counted.

Trip counts are the caller's: it runs a loop body as many times as it
wants counted, or windows (``OpCounter.window``) one pass and multiplies.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCounter", "diff_counts"]

_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "mv", "dot")
_COLLECTIVES = {"allreduce_": "all_reduce", "allgather_": "all_gather",
                "_allgather_base_": "all_gather"}
# DTensor's functional collectives: kind, and the wire bytes per payload
# byte on a ring of n ranks
_FUNCTIONAL = {
    "all_reduce": ("all_reduce", lambda n: 2 * (n - 1) / n),
    "all_gather_into_tensor": ("all_gather", lambda n: n - 1),
    "reduce_scatter_tensor": ("reduce_scatter", lambda n: (n - 1) / n),
    "all_to_all_single": ("all_to_all", lambda n: (n - 1) / n),
    "broadcast": ("broadcast", lambda n: 1.0),
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    """The tensors of ``(args, kwargs)``-like nests of tuples, lists and
    dicts (a hand walk: ``tree_leaves`` costs more than the fake op)."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _matmul_flops(name: str, args, out: torch.Tensor) -> int:
    """``2 * |out| * k``, ``k`` the contracted length: the last dimension
    of the first matrix operand (``addmm`` / ``baddbmm`` lead with the
    bias)."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2 * out.numel() * int(a.shape[-1])


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module
    docstring): ``hbm_bytes``, ``dot_flops``, ``ops``; the collectives by
    kind (``collective_counts``; for functional ones also
    ``collective_bytes`` and ``wire_bytes``); ``live`` and ``peak`` bytes
    of the storages the ops created. ``window(name)`` keeps the counts of
    a stretch of the run in ``windows[name]``."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.dot_flops = 0
        self.ops = 0
        self.collective_counts: Dict[str, int] = {}
        self.collective_bytes: Dict[str, int] = {}
        self.wire_bytes = 0.0
        self._inferring = 0
        self._prop = None
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

    def __enter__(self):
        self._hide_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._prop is not None:
                prop, attr = self._prop
                delattr(prop, attr)
                self._prop = None

    def _hide_propagation(self) -> None:
        """Wrap DTensor's sharding propagator's shape inference so that the
        ops it runs are not counted (it runs them at global shapes, once
        per op schema)."""
        try:
            from torch.distributed.tensor import DTensor
        except ImportError:                 # a build without distributed
            return
        prop = DTensor._op_dispatcher.sharding_propagator
        attr = next((a for a in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(prop, a)), None)
        if attr is None:
            raise RuntimeError("DTensor's sharding propagator has no tensor "
                               "meta inference to hide from the counter")
        inner = getattr(prop, attr)

        def hidden(*a, **kw):
            self._inferring += 1
            try:
                return inner(*a, **kw)
            finally:
                self._inferring -= 1

        setattr(prop, attr, hidden)
        self._prop = (prop, attr)

    _paused = 0

    @classmethod
    @contextlib.contextmanager
    def paused(cls) -> Iterator[None]:
        """Run the block's ops uncounted (a trip window's stand-ins)."""
        cls._paused += 1
        try:
            yield
        finally:
            cls._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._inferring or OpCounter._paused:
            return func(*args, **(kwargs or {}))
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented          # DTensor runs it on the shards
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            name = func.overloadpacket.__name__
            if name in _FUNCTIONAL:
                kind, wire = _FUNCTIONAL[name]
                group = args[-1] if isinstance(args[-1], str) else \
                    kwargs.get("group_name")
                n = _group_size(group)
                nbytes = _nbytes(args[0])
                self.collective_counts[kind] = \
                    self.collective_counts.get(kind, 0) + 1
                self.collective_bytes[kind] = \
                    self.collective_bytes.get(kind, 0) + nbytes
                self.wire_bytes += nbytes * wire(n)
            for t in _tensors(out):        # the result buffer is allocated
                self._track(t, {_key(x) for x in _tensors((args, kwargs))})
            return out
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
                    collective_counts=dict(self.collective_counts),
                    collective_bytes=dict(self.collective_bytes),
                    wire_bytes=self.wire_bytes)

    @contextlib.contextmanager
    def window(self, name: str) -> Iterator[None]:
        """Record the counts of the ops run inside the block as
        ``windows[name]`` (``hbm_bytes``, ``dot_flops``, ``ops``, and the
        collectives issued by kind, ``collective_counts``; with functional
        collectives also their payload bytes by kind, ``collective_bytes``,
        and ``wire_bytes``)."""
        before = self.counts()
        yield
        self.windows[name] = diff_counts(self.counts(), before)
        if not self.windows[name]["collective_bytes"]:
            del self.windows[name]["collective_bytes"]
            del self.windows[name]["wire_bytes"]


def diff_counts(after: dict, before: dict) -> dict:
    """``after - before`` of two ``OpCounter.counts()``: numbers
    subtracted, per-kind dicts subtracted key by key (kinds that did not
    grow left out)."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            was = before.get(k, {})
            out[k] = {kind: n - was.get(kind, 0) for kind, n in v.items()
                      if n > was.get(kind, 0)}
        else:
            out[k] = v - before.get(k, 0)
    return out
