"""The one traffic generator: the keys of a closed loop of queries, drawn
from the seed, and how they are cut into calls.

A traffic mix is ``gbench/traffic/<mix>.json``. Its keys:

- ``query``: the module under ``gbench/queries/`` that turns keys into the
  program's call and the reference's answer;
- ``loop``, ``clients``: ``"closed"`` and 1, the only loop served: a call
  starts when the one before it has returned;
- ``keys``: which vertices may be a key (``"degree_at_least_1"``);
- ``strata``: the candidate ids, ascending, are cut into this many equal
  blocks, and the keys come in rounds that take one fresh key from every
  block, the blocks in a new random order each round, so every seed sends
  the same spread of keys (1: a plain random order);
- ``keys_per_set``, ``lanes_per_call``: a set of keys is served as
  ``keys_per_set / lanes_per_call`` calls of that many lanes each;
- ``check_calls``: how many calls, drawn from the seed among those the
  window finished, are compared with the reference (the slowest call is
  compared as well).

No key repeats within a run: a key that is served is never served again.
"""
from __future__ import annotations

import numpy as np
import torch

from gbench.harness.graphs import EdgeList, generator

__all__ = ["KEY_RULES", "key_sequence", "calls"]


def _degree_at_least_1(edges: EdgeList) -> torch.Tensor:
    return torch.nonzero(edges.degrees() >= 1).flatten()


KEY_RULES = {"degree_at_least_1": _degree_at_least_1}


def key_sequence(edges: EdgeList, traffic: dict, seed: int) -> np.ndarray:
    """Every candidate key once, in the run's order (int64, host)."""
    cand = KEY_RULES[traffic["keys"]](edges)
    strata = int(traffic.get("strata", 1))
    gen = generator(cand.device, seed, "keys")
    per = cand.shape[0] // strata
    if per < 1:
        raise ValueError(f"{cand.shape[0]} candidate keys for {strata} "
                         "strata")
    block = cand[:per * strata].reshape(strata, per)
    shuffled = torch.argsort(torch.rand(strata, per, generator=gen,
                                        device=cand.device), dim=1)
    block = torch.gather(block, 1, shuffled)            # [strata, per]
    order = torch.argsort(torch.rand(per, strata, generator=gen,
                                     device=cand.device), dim=1)
    rounds = torch.gather(block.T, 1, order)            # [per, strata]
    return rounds.reshape(-1).cpu().numpy()


def calls(keys: np.ndarray, traffic: dict):
    """``(warm_up_call, call_iterator)``: each call an int64 array of
    ``lanes_per_call`` keys. The warm-up call takes the sequence's last
    keys, which the window never reaches."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError("the generator serves one client in a closed loop; "
                         f"got loop={traffic.get('loop')!r} "
                         f"clients={traffic.get('clients')!r}")
    lanes = int(traffic["lanes_per_call"])
    per_set = int(traffic["keys_per_set"])
    if per_set % lanes:
        raise ValueError(f"keys_per_set={per_set} is not a multiple of "
                         f"lanes_per_call={lanes}")
    usable = (keys.shape[0] - lanes) // per_set * per_set
    if usable < per_set:
        raise ValueError("too few candidate keys for one set")
    warm = keys[-lanes:]

    def it():
        for i in range(0, usable, lanes):
            yield keys[i:i + lanes]
    return warm, it()
