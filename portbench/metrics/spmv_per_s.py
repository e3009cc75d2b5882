"""spmv_per_s (SpMV/s): right-hand-side columns of the calls that
returned, over the window's seconds on the host's clock (its first call to
the device's last completion)."""


def read(rec):
    if rec.window.solves or rec.window.seconds <= 0:
        return None
    return rec.window.columns * rec.window.completed / rec.window.seconds
