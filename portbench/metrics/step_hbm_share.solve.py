"""step_hbm_share.solve (%): the SpMV's least bytes (values, indices, x
read once, y written once) times the solves' iterations, over the seconds
they took on the host's clock, against the card's HBM bandwidth: the whole
solve step's share, which bounds any gain in what implements it. Read from
the part of the window after the profiler stopped, so the trace's own cost
is not in it."""
from portbench import roofline


def read(rec):
    w = rec.window
    if not w.solves or w.untraced_seconds <= 0 or w.untraced_iterations <= 0:
        return None
    nbytes = roofline.spmv_bytes(rec.nnz, rec.n_rows, rec.n_cols)
    return roofline.hbm_share(nbytes * w.untraced_iterations,
                              w.untraced_seconds, rec.device_kind)
