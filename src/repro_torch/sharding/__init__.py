"""Sharding rules of the port: logical axes -> mesh axes -> DTensor
placements (``sharding.rules``)."""
from repro_torch.sharding.rules import (LOGICAL_RULES, MULTIPOD_RULES,
                                        batch_spec, cache_shardings,
                                        constrain_gathered, get_mesh,
                                        logical_to_spec, maybe_constrain,
                                        param_shardings, rules_for, set_mesh,
                                        to_placements)

__all__ = ["LOGICAL_RULES", "MULTIPOD_RULES", "batch_spec",
           "cache_shardings", "constrain_gathered", "get_mesh",
           "logical_to_spec", "maybe_constrain", "param_shardings",
           "rules_for", "set_mesh", "to_placements"]
