"""Beyond-paper optimization variants: the port of the JAX package's
``configs/variants.py``.

``optimized(cfg)`` returns the config with the per-arch perf levers
flipped; the LM dry run (``launch.dryrun --variant opt``) records baseline
and variant cells separately, so the paper-faithful baseline and the
optimized version are both visible.
"""
from __future__ import annotations

import dataclasses

__all__ = ["optimized"]


def optimized(cfg):
    over = {}
    if cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, dispatch="hierarchical")
    # gather each block's weights at its entry (the FSDP dataflow made
    # explicit: ``sharding.rules.constrain_gathered``)
    over["fsdp_gather_weights"] = True
    # reduce a block output's partial sums while still in the activation
    # dtype, before the norm's float32 upcast
    over["tp_bf16_payload"] = True
    return dataclasses.replace(cfg, **over)
