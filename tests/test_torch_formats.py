"""The port's numpy copies (formats, matrix generators, perf model) against
`repro`: the same seed gives byte-identical CSR and SELL arrays, and the perf
model gives the same numbers."""
import dataclasses

import numpy as np
import pytest

from repro.core import formats as jf
from repro.core import matrices as jm
from repro.core import perfmodel as jp
from repro_torch.core import formats as tf
from repro_torch.core import matrices as tm
from repro_torch.core import perfmodel as tp
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


# (name, generator factory over one of the two matrices modules, seed)
GENERATORS = [
    ("banded", lambda m: m.banded(500, 12, 0.7), 0),
    ("banded-seed9", lambda m: m.banded(333, 5, 0.9), 9),
    ("powerlaw", lambda m: m.powerlaw(400, 6), 1),
    ("powerlaw-skew", lambda m: m.powerlaw(400, 6, skew=3.0), 2),
    ("random_uniform", lambda m: m.random_uniform(300, 7), 3),
    ("spd", lambda m: m.spd(256, 8), 4),
    ("block_diag", lambda m: m.block_diag(320, 16), 5),
    ("hpcg_stencil", lambda m: m.hpcg_stencil(5, 4, 3), 6),
]


def _assert_csr_equal(a, b):
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_sell_equal(a, b):
    assert (a.n_rows, a.n_cols, a.slice_height) == (
        b.n_rows, b.n_cols, b.slice_height)
    for f in ("slice_ptrs", "slice_widths", "colidx", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name,factory,seed", GENERATORS,
                         ids=[g[0] for g in GENERATORS])
def test_generators_give_identical_csr_and_sell(name, factory, seed):
    a = factory(jm)(seed=seed)
    b = factory(tm)(seed=seed)
    _assert_csr_equal(a, b)
    for H, mult in ((32, 1), (8, 4)):
        _assert_sell_equal(
            jf.csr_to_sell(a, slice_height=H, width_multiple=mult),
            tf.csr_to_sell(b, slice_height=H, width_multiple=mult),
        )


def test_generators_accept_an_explicit_rng():
    a = jm.banded(200, 4)(np.random.default_rng(11))
    b = tm.banded(200, 4)(np.random.default_rng(11))
    _assert_csr_equal(a, b)


def test_dense_and_coo_conversions_match():
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((37, 29)) * (rng.random((37, 29)) < 0.2)
    _assert_csr_equal(jf.dense_to_csr(dense), tf.dense_to_csr(dense))
    rows = rng.integers(0, 20, size=90)  # duplicates are summed
    cols = rng.integers(0, 15, size=90)
    vals = rng.standard_normal(90)
    _assert_csr_equal(jf.coo_to_csr(20, 15, rows, cols, vals),
                      tf.coo_to_csr(20, 15, rows, cols, vals))


def test_ci_paper_suite_matches():
    a = jm.paper_suite("ci", seed=3)
    b = tm.paper_suite("ci", seed=3)
    assert list(a) == list(b)
    for name in a:
        _assert_csr_equal(a[name], b[name])


@pytest.mark.parametrize("system", ["base", "pack0", "pack64", "pack256"])
def test_spmv_perf_numbers_match(system):
    a = jf.csr_to_sell(jm.banded(600, 10, 0.6)(seed=1))
    b = tf.csr_to_sell(tm.banded(600, 10, 0.6)(seed=1))
    assert dataclasses.asdict(jp.spmv_perf(a, system)) == dataclasses.asdict(
        tp.spmv_perf(b, system))


def test_matmat_and_streaming_perf_numbers_match():
    a = jf.csr_to_sell(jm.powerlaw(500, 5)(seed=2))
    b = tf.csr_to_sell(tm.powerlaw(500, 5)(seed=2))
    assert dataclasses.asdict(
        jp.matmat_spmv_perf(a, "pack256", k=37, k_tile=8)
    ) == dataclasses.asdict(tp.matmat_spmv_perf(b, "pack256", k=37, k_tile=8))
    assert dataclasses.asdict(
        jp.streaming_spmv_perf(a, "base", k=64, microbatch=16, depth=2)
    ) == dataclasses.asdict(
        tp.streaming_spmv_perf(b, "base", k=64, microbatch=16, depth=2))


def test_csr_from_arrays_carries_a_repro_matrix_across():
    from repro_torch.core.interop import csr_from_arrays

    a = jm.powerlaw(300, 4)(seed=7)
    b = csr_from_arrays(a.n_rows, a.n_cols, a.indptr, a.indices, a.data)
    assert isinstance(b, tf.CSRMatrix)
    _assert_csr_equal(a, b)
    _assert_sell_equal(jf.csr_to_sell(a), tf.csr_to_sell(b))
    with pytest.raises(AssertionError):
        csr_from_arrays(3, 3, [0, 1, 2], [0, 1], [1.0, 2.0])  # indptr short
