"""The port's `SpMVEngine` against `repro`'s on the golden matrices of
tests/test_engine_backends.py: the reference backend bit-identical in
float32, the cuda backend (its kernels' plain versions on a CPU engine)
within 1e-5 of repro's pallas backend, `plan_report` numbers equal, and the
engine/schedule caches (identity, one schedule build per key)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core.formats import csr_to_sell as j_csr_to_sell
from repro.core.formats import dense_to_csr as j_dense_to_csr
from repro_torch.core import engine as te
from repro_torch.core.formats import csr_to_sell, dense_to_csr
from repro_torch.core.spmv import spmv_csr, spmv_sell, spmv_sell_coalesced


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    te.clear_engine_cache()
    te.clear_schedule_cache()
    yield


def _dense_case(n_rows, n_cols, density, slice_height, seed, force_width=None):
    """tests/test_engine_backends.py's `_sell_case` matrix, as a dense array
    (both packages convert it with their own formats module)."""
    rng = np.random.default_rng(seed)
    if force_width is None:
        return rng.standard_normal((n_rows, n_cols)) * (
            rng.random((n_rows, n_cols)) < density
        )
    dense = np.zeros((n_rows, n_cols))
    for r in range(n_rows):
        k = force_width if r == 0 else int(rng.integers(1, force_width + 1))
        cols = rng.choice(n_cols, size=k, replace=False)
        dense[r, cols] = rng.standard_normal(k)
    return dense


GOLDEN_CASES = [  # tests/test_engine_backends.py:52
    dict(n_rows=64, n_cols=96, density=0.12, slice_height=32, seed=0),
    dict(n_rows=70, n_cols=90, density=0.13, slice_height=16, seed=1),
    dict(n_rows=33, n_cols=80, density=0.2, slice_height=8, seed=2,
         force_width=13),
    dict(n_rows=48, n_cols=48, density=0.3, slice_height=8, seed=3),
]
IDS = [f"case{i}" for i in range(len(GOLDEN_CASES))]


def _pair(case):
    dense = _dense_case(**case)
    H = case["slice_height"]
    return (dense, j_csr_to_sell(j_dense_to_csr(dense), slice_height=H),
            csr_to_sell(dense_to_csr(dense), slice_height=H))


def _rhs(seed, n, k=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if k is None else (n, k)).astype(
        np.float32)


@pytest.mark.parametrize("case", GOLDEN_CASES, ids=IDS)
def test_reference_backend_bit_identical_to_repro(case):
    _, jsell, tsell = _pair(case)
    x, X = _rhs(1, tsell.n_cols), _rhs(2, tsell.n_cols, 6)
    ja = je.SpMVEngine(jsell, backend="reference")
    tb = te.SpMVEngine(tsell, backend="reference", device="cpu")
    np.testing.assert_array_equal(np.asarray(ja.matvec(jnp.asarray(x))),
                                  tb.matvec(x).numpy())
    Y = tb.matmat(X).numpy()
    np.testing.assert_array_equal(np.asarray(ja.matmat(jnp.asarray(X))), Y)
    for j in range(X.shape[1]):  # per column, bit-identical to matvec
        np.testing.assert_array_equal(Y[:, j], tb.matvec(X[:, j]).numpy())


def test_reference_backend_bit_identical_on_a_width_padded_plan():
    """The reference executor reduces over the real width only, so a plan
    padded to the kernels' chunk width gives the same bits."""
    _, _, tsell = _pair(GOLDEN_CASES[2])
    x = _rhs(3, tsell.n_cols)
    plain = te.SpMVEngine(tsell, backend="reference", device="cpu")
    padded = te.SpMVEngine(tsell, backend="reference", device="cpu",
                           plan_width_multiple=4)
    assert padded.plan_report()["plan_width"] == 16
    np.testing.assert_array_equal(plain.matvec(x).numpy(),
                                  padded.matvec(x).numpy())


@pytest.mark.parametrize("case", GOLDEN_CASES, ids=IDS)
def test_cuda_backend_on_cpu_matches_repro_pallas(case):
    dense, jsell, tsell = _pair(case)
    x = _rhs(4, tsell.n_cols)
    ja = je.SpMVEngine(jsell, backend="pallas", cols_per_chunk=4)
    tb = te.SpMVEngine(tsell, backend="cuda", cols_per_chunk=4, device="cpu")
    y = tb.matvec(x).numpy()
    assert np.abs(y - np.asarray(ja.matvec(jnp.asarray(x)))).max() <= 1e-5
    np.testing.assert_allclose(y, dense.astype(np.float32) @ x,
                               rtol=2e-4, atol=2e-4)
    rep = tb.plan_report()
    assert rep["backend_resolved"] == "cuda"
    assert rep["plan_width"] % 4 == 0
    assert rep["window"] == 4 * tsell.slice_height


@pytest.mark.parametrize("k", [1, 7, 11])
def test_cuda_backend_fused_matmat_matches_repro_pallas(k):
    _, jsell, tsell = _pair(GOLDEN_CASES[2])
    X = _rhs(5, tsell.n_cols, k)
    ja = je.SpMVEngine(jsell, backend="pallas", cols_per_chunk=4)
    tb = te.SpMVEngine(tsell, backend="cuda", cols_per_chunk=4, device="cpu")
    assert tb.matmat_mode_resolved == "fused"
    Y = tb.matmat(X).numpy()
    assert Y.shape == (tsell.n_rows, k)
    assert np.abs(Y - np.asarray(ja.matmat(jnp.asarray(X)))).max() <= 1e-5
    np.testing.assert_allclose(Y, tb.matmat_vmapped(X).numpy(),
                               rtol=1e-5, atol=1e-5)


def _numbers(report, drop=("backend", "backend_resolved", "device",
                           "cache_health")):
    return {key: v for key, v in report.items() if key not in drop}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_plan_report_numbers_equal_repro(backend):
    _, jsell, tsell = _pair(GOLDEN_CASES[0])
    jb = "pallas" if backend == "cuda" else backend
    ja = je.SpMVEngine(jsell, backend=jb, cols_per_chunk=4)
    tb = te.SpMVEngine(tsell, backend=backend, cols_per_chunk=4, device="cpu")
    stream = {"k": 32, "microbatch": 8, "depth": 2}
    ra = _numbers(ja.plan_report(k=9, stream=stream))
    rb = _numbers(tb.plan_report(k=9, stream=stream))
    assert ra == rb
    assert ("metadata" in rb) == (backend == "cuda")


def test_get_engine_identity_and_one_schedule_build_per_key():
    _, _, tsell = _pair(GOLDEN_CASES[1])
    x = _rhs(6, tsell.n_cols)
    e1 = te.get_engine(tsell, device="cpu")
    assert e1.backend_resolved == "reference"  # auto on a CPU engine
    e1.matvec(x)
    # every spelling of the same resolved plan lands on one engine
    assert te.get_engine(tsell, backend="reference", device="cpu") is e1
    assert te.get_engine(tsell, window=256, device="cpu") is e1
    assert te.get_engine(tsell, device=torch.device("cpu")) is e1
    e1.matvec(x)
    assert te.schedule_cache_stats()["built"] == 1
    e2 = te.get_engine(tsell, backend="cuda", device="cpu")
    assert e2 is not e1
    assert te.get_engine(tsell, backend="cuda", device="cpu") is e2
    e2.matmat(_rhs(7, tsell.n_cols, 3))
    e2.matvec(x)
    assert te.schedule_cache_stats()["built"] == 2
    # a second engine on the same stream reuses the cached schedule object
    e3 = te.SpMVEngine(tsell, backend="cuda", device="cpu", k_tile=4)
    assert e3.schedule is e2.schedule
    assert e3.plan_cached is True
    assert te.schedule_cache_stats()["built"] == 2
    assert te.engine_cache_stats()["size"] == 2


def test_stream_digest_hashes_int32_like_repro():
    stream = np.random.default_rng(8).integers(0, 99, size=77).astype(np.int32)
    assert te.stream_digest(stream) == je.stream_digest(stream)
    s32, _ = te.cached_block_schedule(stream, window=16, block_rows=4,
                                      device="cpu")
    s64, cached = te.cached_block_schedule(stream.astype(np.int64),
                                           window=16, block_rows=4,
                                           device="cpu")
    assert cached and s64 is s32  # int64 input normalized to the same key
    # a CPU tensor plans on its own device: the same key
    s_t, cached = te.cached_block_schedule(torch.as_tensor(stream),
                                           window=16, block_rows=4)
    assert cached and s_t is s32


def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch):
    _, _, tsell = _pair(GOLDEN_CASES[3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.SpMVEngine(tsell)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.get_engine(tsell, backend="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.cached_block_schedule(np.arange(40), window=16, block_rows=4)
    with pytest.raises(ValueError, match="backend"):
        te.SpMVEngine(tsell, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="fused"):
        te.SpMVEngine(tsell, backend="reference", matmat_mode="fused",
                      device="cpu")
    with pytest.raises(ValueError, match="window"):
        te.SpMVEngine(tsell, backend="cuda", window=100, device="cpu")


def test_stage_dispatch_finalize_equals_matmat():
    _, _, tsell = _pair(GOLDEN_CASES[0])
    X = _rhs(9, tsell.n_cols, 5)
    for backend in ("reference", "cuda"):
        eng = te.SpMVEngine(tsell, backend=backend, device="cpu")
        staged = eng.stage(X)
        # a per-micro-batch handle; on the CPU its batch is placed at once
        assert torch.is_tensor(staged.X) and staged.copied is None
        np.testing.assert_array_equal(
            eng.finalize(eng.dispatch(staged)).numpy(), eng.matmat(X).numpy())
        assert eng.matmat(X[:, :0]).shape == (tsell.n_rows, 0)
        assert eng.matmat_vmapped(X[:, :0]).shape == (tsell.n_rows, 0)
        with pytest.raises(ValueError, match="expects"):
            eng.matvec(X)


def test_bf16_values_match_repro_within_storage_precision():
    dense, jsell, tsell = _pair(GOLDEN_CASES[0])
    x = _rhs(10, tsell.n_cols)
    ja = je.SpMVEngine(jsell, backend="reference", value_dtype="bf16")
    tb = te.SpMVEngine(tsell, backend="reference", value_dtype="bf16",
                       device="cpu")
    tc = te.SpMVEngine(tsell, backend="cuda", value_dtype="bf16",
                       cols_per_chunk=4, device="cpu")
    y = tb.matvec(x).numpy()
    np.testing.assert_array_equal(y, np.asarray(ja.matvec(jnp.asarray(x))))
    np.testing.assert_allclose(tc.matvec(x).numpy(), y, rtol=1e-5, atol=1e-5)
    assert tb.plan_values(torch.float32).dtype == torch.bfloat16
    # bf16 storage keeps ~3 significant digits of each value
    bound = 6e-3 * (np.abs(dense) @ np.abs(x))
    assert np.all(np.abs(y - dense @ x) <= bound + 1e-6)


def test_spmv_library_ops_match_dense():
    dense, _, tsell = _pair(GOLDEN_CASES[1])
    x = torch.as_tensor(_rhs(11, tsell.n_cols))
    want = dense.astype(np.float32) @ x.numpy()
    for y in (spmv_csr(dense_to_csr(dense), x), spmv_sell(tsell, x),
              spmv_sell_coalesced(tsell, x)):
        np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)


def test_runtime_geometry_matches_repro():
    from repro.core import runtime as jr
    from repro_torch.core import runtime as tr

    ci = np.arange(2 * 5 * 4, dtype=np.int32).reshape(2, 5, 4)
    va = ci.astype(np.float64) / 7
    for m in (1, 4, 5, 8):
        a, b = jr.pad_width(ci, va, multiple=m), tr.pad_width(ci, va,
                                                             multiple=m)
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for k, n in ((0, 3), (1, 4), (10, 3), (64, 8)):
        assert jr.column_groups(k, n) == tr.column_groups(k, n)
        assert jr.microbatch_slices(k, n) == tr.microbatch_slices(k, n)
    with pytest.raises(ValueError, match="microbatch"):
        tr.microbatch_slices(4, 0)
    _, _, tsell = _pair(GOLDEN_CASES[3])
    assert tr.normalize_to_sell(tsell) is tsell
    with pytest.raises(ValueError, match="re-slice"):
        tr.normalize_to_sell(tsell, slice_height=16)
    with pytest.raises(TypeError):
        tr.normalize_to_sell(np.zeros((2, 2)))
    staged = tr.stage_rhs(np.ones(3, np.float32), torch.device("cpu"))
    assert torch.is_tensor(staged) and staged.dtype == torch.float32
