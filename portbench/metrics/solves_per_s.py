"""solves_per_s (solves/s): solves that returned converged, over the
window's seconds on the host's clock (its first call to its last
completion)."""


def read(rec):
    if not rec.window.solves or rec.window.seconds <= 0:
        return None
    return rec.window.completed / rec.window.seconds
