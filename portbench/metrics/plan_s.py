"""plan_s (s): the benchmark's span from the CSR in hand to a planned
engine: the port's operator (PageRank's transition matrix), `get_engine`
(CSR to SELL, digests), the schedule and device plan, the values placed on
the device."""


def read(rec):
    return rec.plan_s
