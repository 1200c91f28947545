"""The whole query's share of the edge product's memory roofline: the bytes
every product of the traced window needs (``harness/work.product_bytes``)
over the card's published HBM bandwidth times the traced window's length.
It bounds what any kernel of the product can win end to end."""
from gbench.harness.work import product_bytes


def read(run):
    if run.trace is None or run.peak is None or run.vertices_per_part is None:
        return None
    need = sum(product_bytes(c.sweeps, c.edges, run.vertices_per_part,
                             c.lanes, run.weighted) for c in run.calls)
    if not need:
        return None
    return 100.0 * need / (run.peak["hbm_bytes_per_s"] * run.trace.window_s)
