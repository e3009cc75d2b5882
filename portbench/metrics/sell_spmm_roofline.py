"""sell_spmm_roofline (%): the least time of one SpMM of the cell's k
columns on the card (`roofline.spmm_bytes`, `spmm_flops`, counted from the
CSR) over the mean device time of a launch of the SELL kernel's
multi-column instance (`sell_kernel<VT, PACKED, NC > 1, ...>`), from the
trace."""
from portbench import roofline, trace

PATTERN = r"(^|::)sell_kernel<[^,<>]+, *\w+, *([2-9]|\d\d+) *,"


def read(rec):
    got = trace.kernel_seconds(rec.trace, PATTERN)
    if got is None or rec.window.solves:
        return None
    launches, secs = got
    k = rec.window.columns
    least = roofline.least_seconds(
        roofline.spmm_bytes(rec.nnz, rec.n_rows, rec.n_cols, k),
        roofline.spmm_flops(rec.nnz, k), rec.device_kind)
    if least is None:
        return None
    return 100.0 * least / (secs / launches)
