"""solve_host_share (%): of the solves in the untraced tail of a traced
window (the port's `repro.solve` spans recorded after its last span made
under the profiler), the share of their host time not spent in the host
read that ends each block of guarded steps (`repro.solve.probe`, where the
host waits for the device): 100 x (solve time - probe time) / solve time,
summed over the tail. The share of a solve in which the host, not the
device, sets the pace: an upper bound on the device's idle share during
solves, read without the profiler's cost."""


def read(rec):
    if rec.trace is None or not rec.window.solves:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:  # a port that records no spans
        return None
    tail = spans.after_profiler(spans.records())
    if not tail:
        return None
    solves = {r.id: r.end_ns - r.start_ns for r in tail
              if r.name == "repro.solve"}
    total = sum(solves.values())
    if total <= 0:
        return None
    probes = sum(r.end_ns - r.start_ns for r in tail
                 if r.name == "repro.solve.probe" and r.request in solves)
    return 100.0 * (total - probes) / total
