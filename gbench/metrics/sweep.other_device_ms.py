"""Device milliseconds a partition sweep spends outside the port's two
kernels (and their shared second pass): every other kernel, copy and set
of the traced window, over the window's partition sweeps."""
from gbench.harness.trace import owned_seconds

PORT_KERNELS = ("segment_combine_chunks", "bsp_spmv_chunks")


def read(run):
    if run.trace is None:
        return None
    sweeps = sum(sum(c.sweeps) for c in run.calls if c.sweeps is not None)
    if not sweeps:
        return None
    total = sum(s.dur_us for s in run.trace.spans) * 1e-6
    other = total - owned_seconds(run.trace, PORT_KERNELS)
    return 1e3 * other / sweeps
