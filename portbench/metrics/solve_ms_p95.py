"""solve_ms_p95 (ms): the 95th percentile (linear between order
statistics) of the latency of every solve of the window that returned."""
import numpy as np


def read(rec):
    lat = rec.window.latencies_s
    if not rec.window.solves or not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
