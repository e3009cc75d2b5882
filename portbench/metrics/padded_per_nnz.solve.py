"""padded_per_nnz.solve (x): elements the port's plan walks per SpMV
(slices x chunks x window: every slice padded to the widest) over the
operator's nonzeros. A count."""


def read(rec):
    if not rec.window.solves or rec.nnz <= 0:
        return None
    return rec.plan_elements / rec.nnz
