"""Input stand-ins for every (arch x shape) cell of the LM dry run: the port
of the JAX package's ``launch/specs.py``. Each is an empty tensor of the
cell's global shape and dtype (made inside ``FakeTensorMode`` by the dry
run, so nothing is allocated); under an ambient mesh it is a DTensor
placed by the rules' ``batch_spec`` (the batch axis dropped where it does
not divide the batch), and decode caches come from the port's
``models.model.init_cache``, placed by ``cache_specs``.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, ModelConfig, shape_applicable
from repro_torch.sharding import rules as R

__all__ = ["train_batch_specs", "prefill_batch_specs", "decode_batch_specs",
           "cache_len", "input_specs"]


def _empty(shape, dtype, device, key: str):
    """An empty [shape] tensor; over the ambient mesh, a DTensor laid out
    by the rules' ``batch_spec[key]`` (the batch axis dropped where it
    does not divide)."""
    t = torch.empty(tuple(shape), dtype=dtype, device=device)
    mesh = R.get_mesh()
    if mesh is None:
        return t
    from repro_torch.models.sharded import shard_tensor
    spec = R.batch_spec(mesh, with_frontend=True, enc_dec=True)[key]
    spec = R.fit_spec(spec, t.shape, mesh)
    return shard_tensor(t, mesh, R.to_placements(spec, mesh), fresh=True)


def _act(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def _frontend(cfg, global_batch, device):
    return _empty((global_batch, cfg.frontend_len, cfg.frontend_dim),
                  _act(cfg), device, "frontend")


def train_batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                      device=None) -> dict:
    b = {k: _empty((global_batch, seq_len), torch.int32, device, k)
         for k in ("tokens", "labels")}
    if cfg.frontend:
        b["frontend"] = _frontend(cfg, global_batch, device)
    return b


def prefill_batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                        device=None) -> dict:
    b = {"tokens": _empty((global_batch, seq_len), torch.int32, device,
                          "tokens")}
    if cfg.frontend:
        b["frontend"] = _frontend(cfg, global_batch, device)
    return b


def decode_batch_specs(cfg: ModelConfig, global_batch: int,
                       device=None) -> dict:
    b = {"tokens": _empty((global_batch, 1), torch.int32, device,
                          "tokens")}
    if cfg.n_enc_layers:
        b["memory"] = _empty((global_batch, cfg.frontend_len, cfg.d_model),
                             _act(cfg), device, "memory")
    return b


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """KV capacity: the context plus the modality prefix (VLM)."""
    extra = cfg.frontend_len if (cfg.frontend and not cfg.n_enc_layers) else 0
    return seq_len + extra


def input_specs(cfg: ModelConfig, shape_name, device=None):
    """-> (kind, batch, caches or None). kind: train|prefill|decode.
    ``shape_name`` names a cell of ``SHAPES``, or is such a dict itself
    (``kind``, ``seq_len``, ``global_batch``)."""
    if isinstance(shape_name, dict):
        sh = shape_name
    else:
        ok, why = shape_applicable(cfg, shape_name)
        if not ok:
            raise ValueError(f"{cfg.name} x {shape_name} skipped: {why}")
        sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        return "train", train_batch_specs(cfg, sh["seq_len"],
                                          sh["global_batch"], device), None
    if sh["kind"] == "prefill":
        return "prefill", prefill_batch_specs(cfg, sh["seq_len"],
                                              sh["global_batch"],
                                              device), None
    caches = M.init_cache(cfg, sh["global_batch"],
                          cache_len(cfg, sh["seq_len"]), device=device)
    return "decode", decode_batch_specs(cfg, sh["global_batch"],
                                        device), caches
