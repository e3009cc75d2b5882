"""The port's torch coalescer planner against `repro`'s: every schedule field
exactly equal on the golden streams of tests/test_coalescer.py, partial
final windows included, and `n_warps` equal to the step-exact CSHR trace."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coalescer as jc
from repro_torch.core import coalescer as tc
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.interop import schedule_from_arrays, schedule_to_arrays

FIELDS = ("tags", "n_warps", "elem_warp", "elem_offset", "elem_valid")


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _golden_streams():
    """tests/test_coalescer.py's golden streams, same seed and order."""
    rng = np.random.default_rng(1234)
    zipf = np.minimum(rng.zipf(1.3, size=500), 4000) - 1
    return [
        ("random-uniform", rng.integers(0, 4096, size=700)),
        ("random-small-range", rng.integers(0, 64, size=300)),
        ("skewed-zipf", zipf),
        ("all-same-block", np.full(200, 42)),
        ("all-distinct-blocks", np.arange(300) * 8),
        ("sawtooth", np.tile(np.arange(40), 12)),
        ("single-element", np.asarray([7])),
    ]


def _partial_window_streams(window):
    """tests/test_coalescer.py's partial-window streams."""
    rng = np.random.default_rng(77)
    return [
        ("offset-band", rng.integers(0, 64, size=5 * window + 7) + 512),
        ("high-random", rng.integers(1024, 4096, size=window + 1)),
    ]


# jitted: eager op-by-op dispatch of the vmapped planner costs seconds a call
_repro_build = jax.jit(jc.build_block_schedule,
                       static_argnames=("window", "block_rows", "max_warps"))
_repro_gather = jax.jit(jc.schedule_gather_reference, static_argnames="n_out")


def _repro_schedule(idx, **kw):
    return _repro_build(jnp.asarray(idx.astype(np.int32)), **kw)


def _assert_schedules_equal(a, b, name):
    assert (a.window, a.block_rows) == (b.window, b.block_rows)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), getattr(b, f).numpy(),
            err_msg=f"{name}: {f}",
        )


@pytest.mark.parametrize("window,block", [(16, 4), (32, 8), (64, 8), (8, 1)])
def test_schedule_matches_repro_and_cshr_trace(window, block):
    streams = _golden_streams() + _partial_window_streams(window)
    for name, idx in streams:
        kw = dict(window=window, block_rows=block)
        a = _repro_schedule(idx, **kw)
        b = tc.build_block_schedule(idx, **kw, device="cpu")
        _assert_schedules_equal(a, b, name)
        trace = tc.cshr_reference_trace(idx, **kw)
        assert int(b.n_warps.sum()) == len(trace.tags), name


def test_schedule_from_a_tensor_stream_on_its_device():
    idx = np.random.default_rng(3).integers(0, 500, size=333)
    a = _repro_schedule(idx, window=32, block_rows=8)
    b = tc.build_block_schedule(torch.as_tensor(idx), window=32, block_rows=8)
    _assert_schedules_equal(a, b, "tensor")
    assert b.device == torch.device("cpu")


def test_planner_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """Host input planned with no `device` goes to the card, as the engine
    does; without a card that raises instead of planning on the CPU."""
    idx = np.arange(40)
    arrays = schedule_to_arrays(
        tc.build_block_schedule(idx, window=16, block_rows=4, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.build_block_schedule(idx, window=16, block_rows=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.resolve_schedule(idx, window=16, block_rows=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        schedule_from_arrays(arrays, window=16, block_rows=4)


@pytest.mark.parametrize("max_warps", [1, 3, 8])
def test_unique_padded_drops_overflow_like_repro(max_warps):
    """Fewer tag slots than unique blocks: the JAX scatter drops the extra
    ranks (mode="drop"); the port must drop the same ones."""
    x = np.random.default_rng(5).integers(0, 20, size=(6, 16)).astype(np.int32)
    for row in x:
        u_a, n_a = jc._unique_padded(jnp.asarray(row), max_warps)
        u_b, n_b = tc._unique_padded(torch.as_tensor(row)[None], max_warps)
        np.testing.assert_array_equal(np.asarray(u_a), u_b[0].numpy())
        assert int(n_a) == int(n_b[0])


def test_trim_pack_and_meta_bytes_match():
    idx = np.random.default_rng(6).integers(0, 2000, size=1000)
    a = jc.trim_schedule_warps(_repro_schedule(idx, window=64, block_rows=8))
    b = tc.trim_schedule_warps(tc.build_block_schedule(
        idx, window=64, block_rows=8, device="cpu"))
    _assert_schedules_equal(a, b, "trimmed")
    assert b.max_warps < 64
    assert tc.packable_schedule(b) == jc.packable_schedule(a)
    for packed in (True, False):
        assert tc.schedule_meta_bytes(b, packed=packed) == \
            jc.schedule_meta_bytes(a, packed=packed)


def test_schedule_gather_reference_matches_repro_exactly():
    rng = np.random.default_rng(7)
    table = rng.standard_normal((203, 3)).astype(np.float32)  # ragged block
    idx = rng.integers(0, 203, size=150)
    a = _repro_schedule(idx, window=32, block_rows=8)
    b = tc.build_block_schedule(idx, window=32, block_rows=8, device="cpu")
    out_a = np.asarray(_repro_gather(jnp.asarray(table), a, n_out=150))
    out_b = tc.schedule_gather_reference(torch.as_tensor(table), b, 150)
    np.testing.assert_array_equal(out_a, out_b.numpy())
    np.testing.assert_array_equal(out_b.numpy(), table[idx])


def test_trace_statistics_match():
    idx = np.random.default_rng(8).integers(0, 5000, size=4099)
    for window, block in ((16, 4), (256, 8)):
        np.testing.assert_array_equal(
            jc.window_unique_counts(idx, window=window, block_rows=block),
            tc.window_unique_counts(idx, window=window, block_rows=block),
        )
        assert jc.coalesce_stats(idx, window=window, block_rows=block) == \
            tc.coalesce_stats(idx, window=window, block_rows=block)


def test_resolve_schedule_rejects_foreign_geometry():
    idx = torch.arange(100, dtype=torch.int32)
    sched, mw = tc.resolve_schedule(idx, window=16, block_rows=4)
    assert mw == 16 and sched.n_windows == 7
    assert tc.resolve_schedule(idx, window=16, block_rows=4,
                               schedule=sched)[0] is sched
    with pytest.raises(ValueError, match="planned for"):
        tc.resolve_schedule(idx, window=32, block_rows=4, schedule=sched)
    with pytest.raises(ValueError, match="windows"):
        tc.resolve_schedule(idx[:20], window=16, block_rows=4,
                            schedule=sched)


def test_interop_round_trips_a_repro_schedule():
    idx = np.random.default_rng(9).integers(0, 900, size=260)
    a = _repro_schedule(idx, window=32, block_rows=8)
    arrays = {f: np.asarray(getattr(a, f)) for f in FIELDS}
    b = schedule_from_arrays(arrays, window=32, block_rows=8, device="cpu")
    _assert_schedules_equal(a, b, "interop")
    back = schedule_to_arrays(b)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f])
    with pytest.raises(ValueError, match="lack"):
        schedule_from_arrays({"tags": arrays["tags"]}, window=32,
                             block_rows=8, device="cpu")
