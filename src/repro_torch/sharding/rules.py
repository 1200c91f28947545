"""Logical-axis -> mesh-axis sharding rules for the production meshes: the
port of the JAX package's ``sharding/rules.py``, with DTensor placements
in place of ``NamedSharding``.

Single pod  (data=16, model=16):
  - 'model' carries tensor parallelism: attention heads, FFN hidden, vocab,
    experts (expert parallelism), mamba inner channels;
  - 'data' carries batch DP + FSDP (ZeRO-3 parameter sharding on the embed
    dim of every weight matrix).
Multi pod  (pod=2, data=16, model=16):
  - batch and FSDP extend over ('pod', 'data'), pod major;
  - the pod axis only ever carries DP/FSDP traffic, never TP.

KV caches: batch over DP axes, sequence over 'model' (flash-decoding).

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``
holds them: a mesh-axis name, a tuple of names, or ``None``.
``to_placements`` turns it into DTensor placements over a ``DeviceMesh``
with ``mesh_dim_names``: a dim over ``("pod", "data")`` is ``Shard(d)`` on
both mesh dims, the pod dim first, so its blocks are in pod-major order
as JAX splits them.

The ambient mesh (``set_mesh``, the counterpart of ``compat.set_mesh``)
is what ``maybe_constrain``, ``constrain_gathered`` and the models' mesh
paths read; with none active every function here leaves its tensors
alone, so a single-card run is unchanged bit for bit.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Mapping, NamedTuple, Optional, Sequence

__all__ = ["LOGICAL_RULES", "MULTIPOD_RULES", "Sharding", "set_mesh",
           "get_mesh", "rules_for", "logical_to_spec", "fit_spec",
           "to_placements", "spec_placements", "param_shardings",
           "batch_spec", "cache_shardings", "maybe_constrain",
           "constrain_gathered", "gathering_weights", "gather_weights",
           "replicate_partial", "DP_AXES"]

LOGICAL_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,        # kv heads (8) don't divide model=16: replicate
    "ff": "model",
    "ff_expert": None,
    "experts": "model",
    "inner": "model",        # mamba expanded channels
    "embed": "data",         # FSDP / ZeRO-3
    "lora": None,
    "qkv": None,
    "frontend": None,
    "layers": None,
    "batch": "data",
    "kv_seq": "model",
    "seq": None,
}

MULTIPOD_RULES = dict(LOGICAL_RULES, embed=("pod", "data"),
                      batch=("pod", "data"))

#: the data-parallel mesh axes, pod major
DP_AXES = ("pod", "data")

class _State:
    # one ambient mesh per process: a process-wide value (not a thread's),
    # since the backward recomputes checkpointed blocks on autograd's
    # device threads
    mesh = None
    gather = False


_STATE = _State()


class Sharding(NamedTuple):
    """A spec (one mesh-axis entry per tensor dim) and its DTensor
    placements over the mesh it was made for."""
    spec: tuple
    placements: list


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``) the
    ambient mesh for the block. Plain tensors that meet DTensors there
    (positions, masks, the models' scalars) count as replicated
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _STATE.mesh
    _STATE.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _STATE.mesh = prev


def get_mesh():
    """The ambient mesh, or ``None``."""
    return _STATE.mesh


def mesh_shape(mesh) -> tuple:
    """The mesh's dim sizes (read outside any fake-tensor mode: the
    mesh's own tensor is a real one), cached on the mesh."""
    shape = getattr(mesh, "_rules_shape", None)
    if shape is None:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            shape = tuple(int(n) for n in mesh.mesh.shape)
        mesh._rules_shape = shape
    return shape


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh_shape(mesh)))


def _names(m) -> tuple:
    return (m,) if isinstance(m, str) else tuple(m or ())


def rules_for(mesh) -> dict:
    return MULTIPOD_RULES if "pod" in mesh.mesh_dim_names else LOGICAL_RULES


def logical_to_spec(axes, rules) -> tuple:
    """Map a tuple of logical axis names to a spec. A mesh axis may appear
    at most once per spec: repeats (e.g. ('embed','embed') weights) keep
    only the first occurrence and replicate the rest."""
    spec, used = [], set()
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        names = _names(m)
        if any(n in used for n in names):
            m = None
            names = ()
        used.update(names)
        spec.append(m)
    return tuple(spec)


def _divides(dim: int, sizes: dict, m) -> bool:
    return dim % math.prod(sizes[a] for a in _names(m)) == 0


def fit_spec(spec, shape, mesh) -> tuple:
    """``spec`` with every mesh axis that does not divide its dim dropped
    (replicated): e.g. kv_heads=8 on model=16, or an odd vocab."""
    sizes = _sizes(mesh)
    return tuple(m if i < len(shape) and _divides(shape[i], sizes, m)
                 else None for i, m in enumerate(spec))


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``: ``Shard(d)`` on every
    mesh dim named by entry ``d``, ``Replicate()`` elsewhere. A mesh axis
    the mesh lacks is dropped; the names of one entry must follow the
    mesh's order (pod before data), which is the block order DTensor
    gives a dim sharded over several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    dims = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in dims]
    for d, m in enumerate(spec):
        idx = [dims.index(a) for a in _names(m) if a in dims]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {m!r} is not in the mesh's axis "
                             f"order {tuple(dims)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def spec_placements(mesh, shape, *mesh_axes) -> Optional[list]:
    """The placements ``maybe_constrain`` gives a tensor of ``shape``:
    each dim over its mesh axes (a name, a tuple, or None) where they are
    in the mesh and their product is above 1 and divides the dim; None
    when no dim is sharded."""
    sizes = _sizes(mesh)
    spec = []
    for dim, ax in zip(shape, mesh_axes):
        axes = tuple(a for a in _names(ax) if a in sizes)
        n = math.prod(sizes[a] for a in axes)
        spec.append(axes if n > 1 and dim % n == 0 else None)
    if all(s is None for s in spec):
        return None
    return to_placements(spec, mesh)


def param_shardings(mesh, logical: Mapping[str, tuple],
                    shapes: Optional[Mapping] = None) -> dict:
    """``{name: Sharding}`` for a mapping of names to logical-axis tuples
    (``models.model.model_specs``). With ``shapes`` (names to shapes or
    tensors), a mesh axis that does not divide its dim is dropped."""
    rules = rules_for(mesh)
    out = {}
    for name, axes in logical.items():
        spec = logical_to_spec(axes, rules)
        if shapes is not None:
            shp = shapes[name]
            spec = fit_spec(spec, tuple(getattr(shp, "shape", shp)), mesh)
        out[name] = Sharding(spec, to_placements(spec, mesh))
    return out


def batch_spec(mesh, *, with_frontend=False, enc_dec=False) -> dict:
    rules = rules_for(mesh)
    b = rules["batch"]
    out = {"tokens": (b, None), "labels": (b, None)}
    if with_frontend:
        out["frontend"] = (b, None, None)
    if enc_dec:
        out["memory"] = (b, None, None)
    return out


def cache_shardings(mesh, cache_logical: Sequence[Mapping],
                    caches: Sequence[Mapping]) -> list:
    """Per layer, ``{field: Sharding}`` of a decode cache's tensor fields
    (``models.model.cache_specs`` against ``init_cache``'s tensors); the
    host-int ``idx`` has none."""
    return [param_shardings(mesh, {k: ax for k, ax in lg.items()
                                   if k in c and hasattr(c[k], "shape")},
                            c)
            for lg, c in zip(cache_logical, caches)]


def _redistribute(x, mesh, placements):
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(mesh, placements)


def maybe_constrain(x, *mesh_axes):
    """Redistribute ``x`` to the layout ``mesh_axes`` names, one mesh-axis
    name (or tuple of names, or None) per dim; a no-op when no mesh is
    active, and an axis that is absent from the mesh or does not divide
    its dim is dropped. A dim left ``None`` ends replicated, so partial
    sums are reduced, as ``with_sharding_constraint`` does."""
    mesh = get_mesh()
    if mesh is None:
        return x
    pl = spec_placements(mesh, x.shape, *mesh_axes)
    if pl is None:
        return x
    return _redistribute(x, mesh, pl)


@contextlib.contextmanager
def gather_weights(on: bool = True) -> Iterator[None]:
    """While active, ``layers._cast_params`` hands each module's weights
    through ``constrain_gathered`` (the ``fsdp_gather_weights`` lever)."""
    prev = _STATE.gather
    _STATE.gather = on and get_mesh() is not None
    try:
        yield
    finally:
        _STATE.gather = prev


def gathering_weights() -> bool:
    return _STATE.gather


def constrain_gathered(params: Mapping, logical: Mapping) -> dict:
    """Redistribute each weight to its rules' layout with the FSDP
    ('embed') mapping dropped: tensor-parallel axes kept, the per-layer
    weight all-gather made explicit. No-op without a mesh."""
    mesh = get_mesh()
    if mesh is None:
        return dict(params)
    rules = dict(rules_for(mesh), embed=None)
    out = {}
    for name, p in params.items():
        axes = logical.get(name)
        if axes is None or not hasattr(p, "shape"):
            out[name] = p
            continue
        spec = logical_to_spec(axes, rules)
        spec = tuple(spec) + (None,) * (p.ndim - len(spec))
        pl = spec_placements(mesh, p.shape, *spec[:p.ndim])
        out[name] = _redistribute(
            p, mesh, pl or to_placements((None,) * p.ndim, mesh))
    return out


def replicate_partial(x):
    """``x`` with its partial sums reduced (a ``Partial`` placement made
    ``Replicate``), its shards kept: the eager counterpart of
    ``tp_bf16_payload``'s barrier, run while ``x`` is still in the
    activation dtype. No-op without a mesh or a partial placement."""
    from torch.distributed.tensor import DTensor, Replicate
    if get_mesh() is None or not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)
