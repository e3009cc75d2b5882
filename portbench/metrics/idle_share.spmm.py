"""idle_share.spmm (%): the share of the traced part of a matmat window
in which no operation ran on the device (torch.profiler)."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0 \
            or rec.window.solves:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
