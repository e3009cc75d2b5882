"""idle_share.solve (%): the share of the traced part of a solve window
in which no operation ran on the device (torch.profiler). Traced only:
under the profiler each CUDA-graph launch of a solver block takes longer on
the host while the device waits, so this reads above the untraced idle
share; compare it only between traced runs."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0 \
            or not rec.window.solves:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
