"""Production meshes over the current process group, and the fake world of
ranks the capacity dry run builds them in.

Each maker returns a ``DeviceMesh`` with ``mesh_dim_names`` over the first
ranks of the job's process group, row-major, with the JAX package's shapes
and axis names: ``(16, 16)`` as ``("data", "model")`` (one pod) and ``(2,
16, 16)`` as ``("pod", "data", "model")`` (two). ``core/mesh.placement``
then hands a rank its block of it, as for any mesh of the ``shard_map``
backend. The caller creates the process group (NCCL on cards, gloo on the
CPU) with at least as many ranks as the mesh has; ``fake_world`` makes one
of any size in this process alone.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import numpy as np

__all__ = ["make_mesh", "make_production_mesh", "make_graph_mesh",
           "make_host_mesh", "fake_world"]


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` of the current process group. Its device type names
    the rank layout only (``cuda`` under NCCL, else ``cpu``); the graph
    engine's tensors live wherever the caller puts them, while DTensor
    makes its buffers on the mesh's device type."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: "
                           "torch.distributed.init_process_group first "
                           "(or launch.mesh.fake_world for a dry run)")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_graph_mesh(*, multi_pod: bool = False):
    """Same ranks, graph-engine view: (pod, data) -> subgraphs, model ->
    intra-partition edge shards (hierarchical SVHM)."""
    return make_production_mesh(multi_pod=multi_pod)


def make_host_mesh(n: int = 1, axis: str = "data"):
    """Small one-axis mesh for tests and examples."""
    return make_mesh((n,), (axis,))


def _clear_dtensor_caches() -> None:
    """Empty DTensor's caches of sharding decisions and redistribution
    plans. They key on a mesh's value, and a mesh of a later world equals
    one of an earlier world of the same shape, so a cached plan would
    carry the earlier world's (destroyed) process groups."""
    import importlib
    import inspect
    import torch
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return
    objs = list(vars(DTensor._op_dispatcher.sharding_propagator).values())
    for name in ("_sharding_prop", "_redistribute", "_collective_utils"):
        try:
            mod = importlib.import_module(f"torch.distributed.tensor.{name}")
        except ImportError:
            continue
        for obj in vars(mod).values():
            objs.append(obj)
            if inspect.isclass(obj) and obj.__module__ == mod.__name__:
                objs += [getattr(v, "__func__", v)
                         for v in vars(obj).values()]
    for obj in objs:
        if not inspect.isclass(obj) and \
                callable(getattr(obj, "cache_clear", None)):
            obj.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)                 # the C++ dispatch's own cache
    if native is not None:
        native()
    # the meshes flattened or sliced from a root mesh, keyed on its value
    from torch.distributed import device_mesh
    env = getattr(device_mesh, "_mesh_resources", None)
    for v in (vars(env).values() if env is not None else ()):
        if isinstance(v, (dict, list)):
            v.clear()


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A process group of ``world_size`` ranks held by this process alone,
    as rank ``rank``: PyTorch's ``"fake"`` backend, whose collectives move
    nothing and return at once (on fake tensors, with their shapes). It is
    made on entry and destroyed on exit; it refuses to start over a
    process group that is already initialized. DTensor's caches are
    emptied on entry and exit (``_clear_dtensor_caches``)."""
    import torch.distributed as dist
    # PyTorch ships the fake backend's store and registration under
    # torch.testing._internal; importing the module registers "fake"
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "fake world of a dry run needs a process of its "
                           "own")
    _clear_dtensor_caches()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _clear_dtensor_caches()
