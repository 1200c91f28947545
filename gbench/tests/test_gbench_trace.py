"""The trace reader on a hand-made Chrome trace."""
import pytest

from gbench.harness.trace import owned_seconds, summarize


def _x(name, cat, ts, dur, pid=1, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


EVENTS = [
    _x("gbench.window", "user_annotation", 100, 100),
    _x("gbench.call", "user_annotation", 100, 65),
    _x("aten::item", "cpu_op", 150, 8),
    # device, stream 7: busy 110-130, 140-150 (overlap), 170-180
    _x("void segment_combine_chunks<float, 1>(...)", "kernel", 110, 10,
       pid=0, tid=7),
    _x("combine_partials_kernel<float>", "kernel", 120, 10, pid=0, tid=7),
    _x("void bsp_spmv_chunks<float>(...)", "kernel", 140, 5, pid=0, tid=7),
    _x("combine_partials_kernel<float>", "kernel", 143, 7, pid=0, tid=7),
    _x("Memcpy DtoH", "gpu_memcpy", 170, 10, pid=0, tid=7),
    _x("other.window", "user_annotation", 0, 1000, pid=1, tid=2),
]


def test_busy_idle_and_window():
    s = summarize(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)     # 20 + 10 + 10
    names = dict(s.idle_gaps)
    # gaps: 100-110 (call), 130-140 (call), 150-170 (mid 160: item ends
    # at 158, so the call), 180-200 (only the window)
    assert names["gbench.call"] == pytest.approx(40e-6)
    assert names["gbench.window"] == pytest.approx(20e-6)
    ops = dict(s.device_ops)
    assert ops["combine_partials_kernel<float>"] == pytest.approx(17e-6)


def test_helper_kernels_go_to_the_kernel_before_them():
    s = summarize(EVENTS)
    assert owned_seconds(s, ("segment_combine_chunks",)) == \
        pytest.approx(20e-6)
    assert owned_seconds(s, ("bsp_spmv_chunks",)) == pytest.approx(12e-6)


def test_no_window_no_summary():
    assert summarize(EVENTS[1:]) is None
