"""The port's partitioner (`repro_torch.core.partition`, a copy of the JAX
package's numpy module) against `repro.core.partition` on the same
matrices: shard boundaries, costs and diagnostics array-equal for every
strategy."""
import numpy as np
import pytest

from repro.core import formats as jf
from repro.core import matrices as jm
from repro.core import partition as jp
from repro_torch.core import formats as tf
from repro_torch.core import matrices as tm
from repro_torch.core import partition as tp
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache

# (name, generator args, slice height): banded, powerlaw and the skewed
# powerlaw whose clustered hub rows the cost strategies exist for.
MATRICES = {
    "banded": (lambda m: m.banded(600, 12, 0.7), 8),
    "powerlaw": (lambda m: m.powerlaw(700, 8), 8),
    "skewed": (lambda m: m.powerlaw(640, 6, skew=3.0), 8),
    "skewed_tall": (lambda m: m.powerlaw(2048, 6, skew=4.0), 32),
}


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _sells(name):
    gen, h = MATRICES[name]
    t = tf.csr_to_sell(gen(tm)(np.random.default_rng(0)), slice_height=h)
    j = jf.csr_to_sell(gen(jm)(np.random.default_rng(0)), slice_height=h)
    np.testing.assert_array_equal(t.colidx, j.colidx)
    np.testing.assert_array_equal(t.values, j.values)
    return t, j


@pytest.mark.parametrize("strategy", jp.PARTITION_STRATEGIES + ("auto",))
@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_shard_bounds_equal_repro(name, n_shards, strategy):
    t, j = _sells(name)
    tb, tinfo = tp.shard_bounds(t, n_shards, partition=strategy)
    jb, jinfo = jp.shard_bounds(j, n_shards, partition=strategy)
    np.testing.assert_array_equal(tb, jb)
    assert tb[0] == 0 and tb[-1] == t.n_slices
    assert tinfo == jinfo


@pytest.mark.parametrize("window,block_rows", [(256, 8), (128, 4)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_slice_costs_equal_repro(name, window, block_rows):
    t, j = _sells(name)
    np.testing.assert_array_equal(
        tp.slice_costs(t, window=window, block_rows=block_rows),
        jp.slice_costs(j, window=window, block_rows=block_rows),
    )
    np.testing.assert_array_equal(tp.slice_nnz(t), jp.slice_nnz(j))
    bounds = tp.even_bounds(t.n_slices, 3)
    np.testing.assert_array_equal(
        tp.shard_costs_for_bounds(t, bounds, window=window,
                                  block_rows=block_rows),
        jp.shard_costs_for_bounds(j, bounds, window=window,
                                  block_rows=block_rows),
    )


@pytest.mark.parametrize("n_shards", [1, 2, 5])
def test_balanced_bounds_equal_repro(n_shards):
    costs = np.random.default_rng(3).exponential(size=40) ** 2
    np.testing.assert_array_equal(tp.balanced_bounds(costs, n_shards),
                                  jp.balanced_bounds(costs, n_shards))


def test_resolve_partition_and_errors_as_repro():
    assert tp.resolve_partition("auto") == "cost"
    assert tp.PARTITION_STRATEGIES == jp.PARTITION_STRATEGIES
    with pytest.raises(ValueError, match="partition must be one of"):
        tp.resolve_partition("rows")
    t, _ = _sells("banded")
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        tp.shard_bounds(t, 0)
