"""The correctness check, on the CPU at small sizes: a sound run of every
cell is correct; the control put in the program's place is not; and each
fault a cell can have, planted underneath the timed path, turns
``correct`` false. The runs skip only the look for a card."""
import pytest
import torch

from gbench.harness import manifest as mf
from gbench.harness.cell import is_correct, measure
from gbench.tests.sizes import CHECK

MAN = mf.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 2**31 + 77


def _correct(cell, **kw):
    run, checks, attempted, failed, compared = measure(
        cell, SEED, 0.1, False, device="cpu", cfg_override=CHECK, man=MAN,
        **kw)
    assert run.calls and compared
    return is_correct(checks, failed, compared), checks, failed


def _program_class(cell):
    tr = mf.traffic(mf.cell(MAN, cell)["traffic"])
    return type(mf.query(tr["query"]).program(int(tr["lanes_per_call"])))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    ok, checks, _ = _correct(cell)
    assert ok and checks["mismatched_values"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    tr = mf.traffic(mf.cell(MAN, cell)["traffic"])
    control = mf.query(tr["query"]).CONTROLS[0]
    ok, checks, failed = _correct(cell, control=control)
    assert not ok and failed == 0
    assert checks["mismatched_values"]["value"] > 0


def _unchanged_state(mp, cell):
    """Every step returns its state unchanged (and reports no change)."""
    cls = _program_class(cell)
    for name in ("apply_frontier", "sweep_fold"):
        orig = getattr(cls, name)

        def stuck(self, sg, params, state, x, ec=None, _orig=orig):
            args = (sg, params, state, x) + (() if ec is None else (ec,))
            _, changed = _orig(self, *args)
            return state, torch.zeros_like(changed)
        mp.setattr(cls, name, stuck)


def _half_batch(mp, cell):
    """Half of the lanes of a call left out: they come back untouched."""
    cls = _program_class(cell)
    orig = cls.result

    def half(self, sg, params, state):
        out = orig(self, sg, params, state).clone()
        out[..., out.shape[-1] // 2:] = float("inf")
        return out
    mp.setattr(cls, "result", half)


def _no_exchange(mp, cell):
    """The exchange between partitions left out: each keeps its own."""
    from repro_torch.core import sbs
    mp.setattr(sbs.SimExchange, "all_combine",
               lambda self, bufs, combiner: bufs[0])


def _answer_altered(mp, cell):
    """An answer altered where it is produced: a key's own 0 reads 0.5."""
    cls = _program_class(cell)
    orig = cls.result

    def altered(self, sg, params, state):
        out = orig(self, sg, params, state)
        return torch.where(out == 0, torch.full_like(out, 0.5), out)
    mp.setattr(cls, "result", altered)


FAULTS = {"unchanged_state": _unchanged_state, "no_exchange": _no_exchange,
          "answer_altered": _answer_altered, "half_batch": _half_batch}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "half_batch"
         or mf.traffic(mf.cell(MAN, c)["traffic"])["lanes_per_call"] > 1]


@pytest.mark.parametrize("cell,fault", CASES)
def test_planted_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    ok, checks, failed = _correct(cell)
    assert not ok and failed == 0
    assert checks["mismatched_values"]["value"] > 0
