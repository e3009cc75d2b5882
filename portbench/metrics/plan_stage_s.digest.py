"""plan_stage_s.digest (s): the self time (duration less the child spans it
covers) of the port's `repro.plan.digest` spans in the run's planning: the
sha256 digests of the SELL arrays and of the padded index stream. The
planning is the last unbroken run of top-level `repro.plan.*` spans before
the window's calls (`spans.last_planning`); plan spans open only on a miss,
so a warm call records none."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from repro_torch.core import spans
    except ImportError:  # a port that records no spans
        return None
    planning = spans.last_planning(spans.records(), spans.dropped())
    if planning is None:
        return None
    return 1e-9 * spans.self_ns(planning, "repro.plan.digest")
