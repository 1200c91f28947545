"""``segment_combine``'s share of its memory roofline: the bytes the
reduce-by-destination of the window's products needs
(``harness/work.combine_bytes``) over the card's HBM bandwidth times the
kernel's device time in the trace (its second pass included)."""
from gbench.harness.trace import owned_seconds
from gbench.harness.work import combine_bytes

KERNELS = ("segment_combine_chunks",)


def read(run):
    if run.trace is None or run.peak is None or run.vertices_per_part is None:
        return None
    t = owned_seconds(run.trace, KERNELS)
    if t <= 0:
        return None
    need = sum(combine_bytes(c.sweeps, c.edges, run.vertices_per_part,
                             c.lanes) for c in run.calls)
    return 100.0 * need / (run.peak["hbm_bytes_per_s"] * t)
