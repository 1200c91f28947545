"""The readers of the program's counters against hand-counted call
records; the control's records carry no counters, and its readers read
nothing."""
from types import SimpleNamespace

import pytest

from gbench.harness import manifest as mf
from gbench.harness.cell import CallRecord

CALLS = [CallRecord(0.5, 1, 40, [10, 0, 5], [100, 0, 50], 3),
         CallRecord(0.7, 1, 60, [20, 4, 1], [100, 0, 50], 7)]
CONTROL = [CallRecord(0.5, 1, None, None, None, None)]


@pytest.mark.parametrize("name,want", [("host_syncs_per_query", 50.0),
                                       ("sweeps_per_query", 20.0),
                                       ("supersteps_per_query", 5.0)])
def test_counter_readers(name, want):
    read = mf.metric_reader(name)
    assert read(SimpleNamespace(calls=CALLS)) == want
    assert read(SimpleNamespace(calls=CONTROL)) is None
