"""The port's streaming executor (`repro_torch.core.runtime`), held to
`repro.core.runtime`: streamed output equals the synchronous engine bit for
bit on the reference backend (within 1e-5 through the kernels' plain
versions), and the pipeline's order, backpressure, retries, timeouts,
validation and empty batches behave as in `tests/test_runtime.py`."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import runtime as jruntime
from repro.core.engine import SpMVEngine as JEngine
from repro.core.formats import csr_to_sell as j_csr_to_sell, \
    dense_to_csr as j_dense_to_csr
from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
    clear_schedule_cache
from repro_torch.core.formats import csr_to_sell, dense_to_csr
from repro_torch.core.runtime import Executor, StreamingExecutor, \
    StreamTimeout, microbatch_slices, parse_stream_spec

RNG = np.random.default_rng(77)


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _dense(n_rows, n_cols, density, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rows, n_cols)) * (
        rng.random((n_rows, n_cols)) < density)


def _engine(n_rows, n_cols, density, seed, slice_height=8, **kw):
    sell = csr_to_sell(dense_to_csr(_dense(n_rows, n_cols, density, seed)),
                       slice_height=slice_height)
    return SpMVEngine(sell, device="cpu", **{"backend": "reference", **kw})


def _rhs(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


@pytest.mark.parametrize("n_rows,n_cols,k,microbatch,depth,seed", [
    (40, 64, 17, 5, 2, 1),
    (90, 120, 3, 8, 4, 2),   # k < microbatch
    (8, 16, 12, 1, 1, 3),    # one column a micro-batch, synchronous depth
    (33, 80, 9, 2, 4, 4),    # depth > micro-batches of a batch
])
def test_streamed_matmat_bit_identical_to_sync_reference(
        n_rows, n_cols, k, microbatch, depth, seed):
    eng = _engine(n_rows, n_cols, 0.2, seed)
    X = _rhs(n_cols, k, seed + 1)
    want = eng.matmat(X)
    streamer = StreamingExecutor(eng, microbatch=microbatch, depth=depth)
    assert torch.equal(streamer.matmat(X), want)
    assert torch.equal(streamer.matmat(torch.as_tensor(X)), want)
    # the same numbers as repro's reference engine, streamed or not
    jsell = j_csr_to_sell(j_dense_to_csr(_dense(n_rows, n_cols, 0.2, seed)),
                          slice_height=8)
    jY = jruntime.StreamingExecutor(JEngine(jsell, backend="reference"),
                                    microbatch=microbatch,
                                    depth=depth).matmat(X)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jY))


def test_streamed_kernel_backend_within_tolerance_and_odd_width():
    """The kernels' plain versions stream through the same pipeline, on a
    width that is not a multiple of cols_per_chunk."""
    dense = np.zeros((33, 80))
    rng = np.random.default_rng(2)
    for r in range(33):
        cols = rng.choice(80, size=13 if r == 0 else int(rng.integers(1, 14)),
                          replace=False)
        dense[r, cols] = rng.standard_normal(cols.size)
    sell = csr_to_sell(dense_to_csr(dense), slice_height=8)
    X = _rhs(80, 6, 3)
    ref = SpMVEngine(sell, backend="reference", device="cpu").matmat(X)
    eng = SpMVEngine(sell, backend="cuda", cols_per_chunk=4, device="cpu")
    got = StreamingExecutor(eng, microbatch=4, depth=2).matmat(X)
    assert float((got - ref).abs().max()) <= 1e-5
    # the plain kernels take each micro-batch's columns as the sync call does
    assert torch.equal(got[:, :4], eng.matmat(X[:, :4]))


def test_streamed_matvec_empty_batch_and_call():
    eng = _engine(40, 64, 0.15, 5)
    streamer = StreamingExecutor(eng, microbatch=4, depth=2)
    x = RNG.standard_normal(64).astype(np.float32)
    assert torch.equal(streamer.matvec(x), eng.matvec(x))
    assert torch.equal(streamer(x), eng.matvec(x))
    empty = streamer.matmat(np.zeros((64, 0), np.float32))
    assert tuple(empty.shape) == (40, 0) and empty.dtype == torch.float32
    X0 = np.zeros((64, 0), np.float32)
    piped = eng.finalize(eng.dispatch(eng.stage(X0)))
    assert tuple(piped.shape) == (40, 0) and piped.dtype == torch.float32


def test_engine_implements_executor_protocol():
    eng = _engine(32, 48, 0.2, 7)
    assert isinstance(eng, Executor)
    X = _rhs(48, 5, 8)
    assert torch.equal(eng.finalize(eng.dispatch(eng.stage(X))),
                       eng.matmat(X))
    with pytest.raises(TypeError, match="Executor"):
        StreamingExecutor(object())


def test_submit_drain_order_and_backpressure():
    eng = _engine(48, 64, 0.15, 9)
    streamer = StreamingExecutor(eng, microbatch=2, depth=3)
    batches = [_rhs(64, k, 10 + k) for k in (5, 1, 7, 4)]
    max_seen, handles = 0, []
    for B in batches:
        handles.append(streamer.submit(B))
        assert streamer.in_flight <= 3
        max_seen = max(max_seen, streamer.in_flight)
    outs = streamer.drain()
    assert streamer.in_flight == 0 and max_seen == 3
    assert [o.shape[1] for o in outs] == [5, 1, 7, 4]
    for B, out in zip(batches, outs):
        assert torch.equal(out, eng.matmat(B))
    assert all(h.done for h in handles)
    assert streamer.drain() == []


def test_handles_collect_their_own_batches_once():
    eng = _engine(48, 64, 0.15, 11)
    streamer = StreamingExecutor(eng, microbatch=4, depth=2)
    A, B = _rhs(64, 6, 12), _rhs(64, 3, 13)
    ha, hb = streamer.submit(A), streamer.submit(B)
    assert torch.equal(hb.result(), eng.matmat(B))
    outs = streamer.drain()  # A only: B was collected by its handle
    assert len(outs) == 1 and torch.equal(outs[0], eng.matmat(A))
    assert torch.equal(ha.result(), outs[0])  # result() stays idempotent


def test_concurrent_submitters_keep_parity():
    """More submitting threads than cores share one pipeline, with the
    interpreter switching threads often: every result is its own batch's."""
    eng = _engine(64, 96, 0.15, 21)
    streamer = StreamingExecutor(eng, microbatch=3, depth=2)
    n_threads = 2 * (os.cpu_count() or 4)
    mats = [_rhs(96, 7, 100 + i) for i in range(3 * n_threads)]
    expected = [eng.matmat(m) for m in mats]
    results = [None] * len(mats)

    def worker(lo, hi):
        for i in range(lo, hi):
            results[i] = streamer.submit(mats[i]).result()

    threads = [threading.Thread(target=worker, args=(j * 3, j * 3 + 3))
               for j in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert streamer.drain() == []
    for got, want in zip(results, expected):
        assert torch.equal(got, want)


def _flaky_finalize(eng, fail_calls, exc=None):
    real = eng.finalize
    calls = {"n": 0}

    def flaky(pending):
        calls["n"] += 1
        if calls["n"] in fail_calls:
            raise exc or RuntimeError("transient device error")
        return real(pending)

    return flaky


def test_failures_fail_their_batch_and_keep_the_pipeline_usable():
    eng = _engine(48, 64, 0.15, 27)
    X = _rhs(64, 6, 28)
    streamer = StreamingExecutor(eng, microbatch=4, depth=2)
    eng.finalize = _flaky_finalize(eng, range(1, 100),
                                   RuntimeError("device fell over"))
    h = streamer.submit(X)
    with pytest.raises(RuntimeError, match="device fell over"):
        h.result()
    assert h.done and h.failed
    del eng.finalize
    assert streamer.drain() == []
    assert torch.equal(streamer.matmat(X), eng.matmat(X))

    streamer = StreamingExecutor(eng, microbatch=8, depth=2)
    bad, good = _rhs(64, 4, 32), _rhs(64, 4, 33)
    eng.finalize = _flaky_finalize(eng, {1})
    hb = streamer.submit(bad)
    streamer.submit(good)
    outs = streamer.drain()
    del eng.finalize
    assert len(outs) == 1 and torch.equal(outs[0], eng.matmat(good))
    assert not outs.ok and len(outs.failures) == 1
    failure = outs.failures[0]
    assert (failure.index, failure.k, failure.retries) == (0, 4, 0)
    assert "transient device error" in str(failure.error)
    assert hb.failed and hb.error is failure.error
    assert streamer.drain() == [] and streamer.stats["failures"] == 1


def test_microbatch_retry_recovers_transient_failures():
    eng = _engine(48, 64, 0.15, 33)
    X = _rhs(64, 10, 34)
    streamer = StreamingExecutor(eng, microbatch=4, depth=2, retries=2)
    eng.finalize = _flaky_finalize(eng, {2, 3})
    streamer.submit(X)
    outs = streamer.drain()
    del eng.finalize
    assert outs.ok and torch.equal(outs[0], eng.matmat(X))
    assert streamer.stats == {"retries": 2, "timeouts": 0, "failures": 0}


def test_microbatch_timeout_is_reported_after_retries():
    eng = _engine(32, 48, 0.2, 35)
    X = _rhs(48, 3, 36)
    real = eng.finalize
    eng.finalize = lambda pending: (time.sleep(0.6), real(pending))[1]
    streamer = StreamingExecutor(eng, microbatch=4, timeout=0.05, retries=1)
    streamer.submit(X)
    outs = streamer.drain()
    del eng.finalize
    assert len(outs.failures) == 1
    assert isinstance(outs.failures[0].error, StreamTimeout)
    assert outs.failures[0].retries == 1
    assert streamer.stats["timeouts"] >= 1
    assert torch.equal(streamer.matmat(X), eng.matmat(X))


def test_validate_rejects_nonfinite_rhs():
    eng = _engine(32, 48, 0.2, 37)
    X = _rhs(48, 4, 38)
    X[5, 2] = np.nan
    guarded = StreamingExecutor(eng, validate=True)
    for bad in (X, torch.as_tensor(X)):
        with pytest.raises(ValueError, match="non-finite"):
            guarded.submit(bad)
    assert guarded.drain() == []
    X[5, 2] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        guarded.matmat(X)
    out = StreamingExecutor(eng).matmat(X)  # default: the caller's poison
    assert bool(torch.isinf(out).any() or torch.isnan(out).any())


def test_streaming_executor_validation_and_report():
    eng = _engine(48, 64, 0.15, 13)
    with pytest.raises(ValueError, match="microbatch"):
        StreamingExecutor(eng, microbatch=0)
    with pytest.raises(ValueError, match="depth"):
        StreamingExecutor(eng, depth=0)
    with pytest.raises(ValueError, match="timeout"):
        StreamingExecutor(eng, timeout=0)
    streamer = StreamingExecutor(eng, microbatch=8, depth=2)
    with pytest.raises(ValueError, match="submit"):
        streamer.submit(np.zeros((65, 2), np.float32))
    with pytest.raises(ValueError, match="matvec"):
        streamer.matvec(np.zeros(65, np.float32))
    s = streamer.plan_report(k=32)["streaming"]
    assert (s["k"], s["microbatch"], s["depth"]) == (32, 8, 2)
    jsell = j_csr_to_sell(j_dense_to_csr(_dense(48, 64, 0.15, 13)),
                          slice_height=8)
    js = jruntime.StreamingExecutor(
        JEngine(jsell, backend="reference"), microbatch=8, depth=2,
    ).plan_report(k=32)["streaming"]
    assert s == js  # the perf model's overlap prediction, number for number


def test_geometry_helpers_and_stream_spec_equal_repro():
    for k, mb in ((10, 4), (3, 8), (0, 4), (23, 5)):
        assert microbatch_slices(k, mb) == jruntime.microbatch_slices(k, mb)
    for spec in ("depth=3,microbatch=16", "microbatch=8", ""):
        assert parse_stream_spec(spec) == jruntime.parse_stream_spec(spec)
    for bad in ("depth=0", "bogus=3", "depth", "depth=x"):
        with pytest.raises(ValueError, match="stream"):
            parse_stream_spec(bad)
