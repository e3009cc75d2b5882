"""sell_spmv_roofline (%): the least time of one SpMV on the card (its
bytes and FLOPs counted from the CSR: `roofline.spmv_bytes`, `spmv_flops`)
over the mean device time of a launch of the SELL kernel's one-column
instance (`sell_kernel<VT, PACKED, 1, ...>`), from the trace."""
from portbench import roofline, trace

PATTERN = r"(^|::)sell_kernel<[^,<>]+, *\w+, *1 *,"


def read(rec):
    got = trace.kernel_seconds(rec.trace, PATTERN)
    if got is None:
        return None
    launches, secs = got
    least = roofline.least_seconds(
        roofline.spmv_bytes(rec.nnz, rec.n_rows, rec.n_cols),
        roofline.spmv_flops(rec.nnz), rec.device_kind)
    if least is None:
        return None
    return 100.0 * least / (secs / launches)
