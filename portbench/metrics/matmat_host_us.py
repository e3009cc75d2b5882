"""matmat_host_us (us): the mean host time for `SpMVEngine.matmat` to
return (the benchmark's span around each call: staging, dispatch and the
kernel's launch, not its run)."""


def read(rec):
    h = rec.window.host_s
    if rec.window.solves or not h:
        return None
    return 1e6 * sum(h) / len(h)
