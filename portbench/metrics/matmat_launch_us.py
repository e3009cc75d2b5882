"""matmat_launch_us (us): the mean host time of the port's
`repro.matmat.launch` spans (`SpMVEngine.dispatch`: the kernel wrapper's
launch and the completion event's record) in the untraced tail of a traced
window (after the port's last span made under the profiler)."""


def read(rec):
    if rec.trace is None or rec.window.solves:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:  # a port that records no spans
        return None
    tail = spans.after_profiler(spans.records())
    if not tail:
        return None
    launches = [r.end_ns - r.start_ns for r in tail
                if r.name == "repro.matmat.launch"]
    if not launches:
        return None
    return 1e-3 * sum(launches) / len(launches)
