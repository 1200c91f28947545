"""DRONE programming API (paper §5.1) on PyTorch tensors.

A ``VertexProgram`` describes

  - how to initialize per-partition state                 (init)
  - how to consume merged frontier data at a boundary     (apply_frontier)
  - one local relaxation sweep over the partition         (sweep)
  - which per-vertex payload to contribute to SBS         (frontier_out)

Unlike the JAX package, whose methods see one partition under ``vmap``,
every method here works on the **stacked batch**: ``sg`` is the whole
``[P, ...]`` ``DeviceSubgraph``, state tensors are ``[P, v_max(, K)]`` and
change counts are ``[P]`` int32 tensors. Edge indices are partition-local,
so gathers and scatters run along the last vertex axis.

Programs whose sweep is a semiring SpMV declare it as a ``SemiringSweep``
plus ``sweep_values``/``sweep_fold``; the engine then runs the product on
the configured edge backend (``coo_semiring_product`` or one of the CUDA
kernels) without the program noticing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import combine_identity as _combine_identity
from repro_torch.kernels.ref import numpy_dtype, torch_dtype

__all__ = ["DeviceSubgraph", "SemiringSweep", "VertexProgram",
           "coo_semiring_product", "combiner_identity", "torch_dtype",
           "numpy_dtype"]

class DeviceSubgraph(NamedTuple):
    """Stacked per-partition device tensors ([P, ...])."""
    esrc: torch.Tensor     # [P, e_max] int32 local src
    edst: torch.Tensor     # [P, e_max] int32 local dst (ascending)
    ew: torch.Tensor       # [P, e_max] f32
    emask: torch.Tensor    # [P, e_max] bool
    slot: torch.Tensor     # [P, v_max] int32 frontier slot (n_slots if none)
    vmask: torch.Tensor    # [P, v_max] bool
    vid32: torch.Tensor    # [P, v_max] int32 global vertex id (INT32_MAX pad)
    is_frontier: torch.Tensor  # [P, v_max] bool
    out_deg: torch.Tensor  # [P, v_max] f32 full out-degree
    in_deg: torch.Tensor   # [P, v_max] f32 full in-degree
    is_master: torch.Tensor  # [P, v_max] bool
    vlabel: Optional[torch.Tensor] = None  # [P, v_max] int32

    @property
    def n_parts(self) -> int:
        return self.vmask.shape[0]

    @property
    def v_max(self) -> int:
        return self.vmask.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.vmask.device

    @property
    def frontier(self) -> torch.Tensor:
        """[P, v_max] bool — valid vertices that have an SBS slot."""
        return self.vmask & self.is_frontier

    @property
    def internal(self) -> torch.Tensor:
        """[P, v_max] bool — valid vertices living only in one partition."""
        return self.vmask & ~self.is_frontier

    def gather(self, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``vals[p, idx[p, e]]`` for [P, v_max(, K)] ``vals`` and [P, e]
        local indices."""
        i = idx.long()
        if vals.dim() == 3:
            i = i[..., None].expand(-1, -1, vals.shape[-1])
        return torch.gather(vals, 1, i)


# The engine's supported (combiner, dtype) envelope.
COMBINER_IDENTITY = {
    (c, np.dtype(d)): _combine_identity(c, d)
    for c in ("min", "max", "sum")
    for d in (np.float32, np.int32)
}


def combiner_identity(combiner: str, dtype: Any) -> np.generic:
    try:
        return COMBINER_IDENTITY[(combiner, numpy_dtype(dtype))]
    except KeyError:
        supported = ", ".join(
            f"({c!r}, {d.name})" for c, d in sorted(
                COMBINER_IDENTITY, key=lambda k: (k[0], k[1].name)))
        raise ValueError(
            f"no combiner identity for (combiner={combiner!r}, "
            f"dtype={dtype}); supported (combiner, dtype) pairs: "
            f"{supported}") from None


@dataclasses.dataclass(frozen=True)
class SemiringSweep:
    """Declarative local-sweep spec: the partition-local relaxation is a
    semiring SpMV over the partition's adjacency:

      min_plus    agg[d] = min_e  vals[src(e)] + ev(e)   (SSSP relax, CC
                  min-label propagation with ev = 0)
      plus_times  agg[d] = sum_e  vals[src(e)] * ev(e)   (PageRank push
                  with ev = 1; vals carry the alpha/out_deg rate)

    ``edge_values`` names the edge-value map (``'weight'`` | ``'zero'`` |
    ``'one'``) so the tile backend can bake it into its layouts."""

    semiring: str                    # 'min_plus' | 'plus_times'
    edge_values: str = "weight"      # 'weight' | 'zero' | 'one'

    _SEMIRINGS: ClassVar[Tuple[str, ...]] = ("min_plus", "plus_times")
    _EDGE_VALUES: ClassVar[Tuple[str, ...]] = ("weight", "zero", "one")

    def __post_init__(self) -> None:
        if self.semiring not in self._SEMIRINGS:
            raise ValueError(f"SemiringSweep.semiring={self.semiring!r}: "
                             f"allowed values are {self._SEMIRINGS}")
        if self.edge_values not in self._EDGE_VALUES:
            raise ValueError(
                f"SemiringSweep.edge_values={self.edge_values!r}: allowed "
                f"values are {self._EDGE_VALUES}")

    @property
    def combiner(self) -> str:
        return "min" if self.semiring == "min_plus" else "sum"

    def identity(self, dtype: Any) -> np.generic:
        return combiner_identity(self.combiner, dtype)


def coo_semiring_product(sg: DeviceSubgraph, spec: SemiringSweep,
                         vals: torch.Tensor) -> torch.Tensor:
    """The COO edge backend over the stacked graph: gather the source
    values, combine with the edge values, and reduce by destination with
    ``scatter_reduce_`` (``amin`` or ``sum``, starting from the identity).
    All P partitions go through one flattened scatter, offset by
    ``p * v_max``. ``vals`` is [P, v_max] or [P, v_max, K]; the aggregate
    has the same shape."""
    ident = spec.identity(vals.dtype).item()
    P, v_max = vals.shape[0], vals.shape[1]
    if spec.edge_values == "weight":
        ev = sg.ew.to(vals.dtype)
    elif spec.edge_values == "zero":
        ev = torch.zeros_like(sg.ew, dtype=vals.dtype)
    else:
        ev = torch.ones_like(sg.ew, dtype=vals.dtype)
    sv = sg.gather(vals, sg.esrc)                        # [P, e_max(, K)]
    emask = sg.emask
    if vals.dim() == 3:
        ev = ev[..., None]
        emask = emask[..., None]
    cand = sv + ev if spec.semiring == "min_plus" else sv * ev
    cand = torch.where(emask, cand, torch.full((), ident, dtype=vals.dtype,
                                               device=vals.device))
    offs = torch.arange(P, device=vals.device)[:, None] * v_max
    idx = (sg.edst.long() + offs).reshape(-1)
    flat = vals.reshape(P * v_max, -1)
    cand = cand.reshape(idx.shape[0], -1)
    idx = idx[:, None].expand(-1, flat.shape[1])
    agg = torch.full_like(flat, ident)
    reduce = "amin" if spec.semiring == "min_plus" else "sum"
    agg.scatter_reduce_(0, idx, cand, reduce, include_self=True)
    return agg.reshape(vals.shape)


@dataclasses.dataclass
class VertexProgram:
    """Base class; subclasses implement the methods below on stacked
    ``[P, ...]`` tensors.

    combiner:    'min' | 'sum' | 'max' — the SBS Aggregate operator (§4.3).
    payload:     K, width of the per-vertex exchanged vector.
    dtype:       numpy dtype of the exchanged payload (float32 or int32).
    delta_based: frontier_out is a sum-combined delta (PageRank) rather
                 than the value itself (SSSP, CC).
    tol:         significance threshold for float change detection.
    monotone:    values only tighten under the combiner, so a previous
                 converged result is a sound warm start.
    value_key:   state entry holding the values ``warm_init`` tightens.
    """

    combiner: str = "min"
    payload: int = 1
    dtype: Any = np.float32
    delta_based: bool = False
    tol: float = 0.0
    monotone: bool = False
    value_key: Optional[str] = None

    warm_under: ClassVar[str] = "inserts"
    # Edge backends a hand-rolled ``sweep`` implements (None: derived from
    # the sweep kind — declarative programs support every backend).
    supports_edge_backends: ClassVar[Optional[Tuple[str, ...]]] = None
    sweep_spec: ClassVar[Optional[SemiringSweep]] = None

    def init(self, sg: DeviceSubgraph, params: Any, ec: Any) -> Any:
        """Build the stacked per-partition state. ``ec`` is the engine's
        EdgeCombine context for edge-derived reductions."""
        raise NotImplementedError

    def apply_frontier(self, sg: DeviceSubgraph, params: Any, state: Any,
                       merged: torch.Tensor,
                       ec: Any) -> Tuple[Any, torch.Tensor]:
        """Consume merged [P, v_max, K] (identity at non-frontier rows).
        Returns (state, [P] int32 changed counts)."""
        raise NotImplementedError

    def sweep_values(self, sg: DeviceSubgraph, params: Any,
                     state: Any) -> torch.Tensor:
        """Values entering the semiring product ([P, v_max] or
        [P, v_max, K])."""
        raise NotImplementedError

    def sweep_fold(self, sg: DeviceSubgraph, params: Any, state: Any,
                   agg: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        """Fold the product's aggregate back into state. Returns
        (state, [P] int32 changed counts)."""
        raise NotImplementedError

    def sweep(self, sg: DeviceSubgraph, params: Any, state: Any,
              ec: Any) -> Tuple[Any, torch.Tensor]:
        """One local relaxation pass on the COO backend."""
        spec = self.sweep_spec
        if spec is None:
            raise NotImplementedError(
                f"{type(self).__name__} defines neither sweep_spec nor a "
                "sweep override")
        vals = self.sweep_values(sg, params, state)
        agg = coo_semiring_product(sg, spec, vals)
        agg = ec.min(agg) if spec.semiring == "min_plus" else ec.sum(agg)
        return self.sweep_fold(sg, params, state, agg)

    def frontier_out(self, sg: DeviceSubgraph, params: Any,
                     state: Any) -> torch.Tensor:
        """Per-vertex SBS contribution [P, v_max, K]."""
        raise NotImplementedError

    def result(self, sg: DeviceSubgraph, params: Any,
               state: Any) -> torch.Tensor:
        """Per-vertex output [P, v_max(, ...)]."""
        raise NotImplementedError

    def warm_init(self, sg: DeviceSubgraph, params: Any, state: Any,
                  warm: torch.Tensor) -> Any:
        """Tighten ``state[value_key]`` with a previous converged result
        ``warm`` ([P, v_max, K], identity at padded rows, program dtype)."""
        if not (self.monotone and self.value_key):
            raise ValueError("warm_init requires a monotone program with "
                             "value_key set")
        if self.combiner not in ("min", "max"):
            raise ValueError("default warm_init only knows min/max "
                             "tightening; override it")
        cur = state[self.value_key]
        w = warm if cur.dim() == warm.dim() else warm[..., 0]
        op = torch.minimum if self.combiner == "min" else torch.maximum
        mask = sg.vmask if cur.dim() == 2 else sg.vmask[..., None]
        state = dict(state)
        state[self.value_key] = torch.where(mask, op(cur, w.to(cur.dtype)),
                                            cur)
        return state

    @property
    def identity(self) -> np.generic:
        return combiner_identity(self.combiner, self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def changed_mask(self, out: torch.Tensor,
                     last_out: torch.Tensor) -> torch.Tensor:
        """[P, v_max] bool — which vertices would emit a (key,value) pair."""
        if self.delta_based:
            if self.tol > 0:
                return torch.any(out.abs() > self.tol, dim=-1)
            return torch.any(out != 0, dim=-1)
        if self.tol > 0:
            return torch.any((out - last_out).abs() > self.tol, dim=-1)
        return torch.any(out != last_out, dim=-1)
