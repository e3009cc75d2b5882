"""useful_matvec_share (%): the solves' iterations over the matvecs the
port ran for them (`SolveResult.iterations / matvecs`, summed over the
window); the rest are cg's initial residual and guarded steps past
convergence."""


def read(rec):
    w = rec.window
    if not w.solves or w.matvecs <= 0:
        return None
    return 100.0 * w.iterations / w.matvecs
