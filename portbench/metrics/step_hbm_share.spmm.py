"""step_hbm_share.spmm (%): the SpMM's least bytes (values, indices, X
read once, Y written once) times the calls completed, over the seconds they
took on the host's clock, against the card's HBM bandwidth. Read from the
part of the window after the profiler stopped."""
from portbench import roofline


def read(rec):
    w = rec.window
    if w.solves or w.untraced_seconds <= 0 or w.untraced_completed <= 0:
        return None
    nbytes = roofline.spmm_bytes(rec.nnz, rec.n_rows, rec.n_cols, w.columns)
    return roofline.hbm_share(nbytes * w.untraced_completed,
                              w.untraced_seconds, rec.device_kind)
