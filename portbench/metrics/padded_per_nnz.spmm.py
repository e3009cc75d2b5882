"""padded_per_nnz.spmm (x): elements the port's plan walks per pass of a SpMM
(slices x chunks x window: every slice padded to the widest) over the
operator's nonzeros. A count."""


def read(rec):
    if rec.window.solves or rec.nnz <= 0:
        return None
    return rec.plan_elements / rec.nnz
