"""The frozen generators at small scale: sizes, symmetry, determinism."""
import numpy as np
import pytest

from portbench.generators import hpcg, kronecker

KRON = {"scale": 8, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
        "seed": 5}


@pytest.mark.parametrize("nx,ny,nz", [(1, 1, 1), (2, 3, 4), (5, 5, 5)])
def test_stencil_sizes(nx, ny, nz):
    n, indptr, indices, data = hpcg.build({"nx": nx, "ny": ny, "nz": nz},
                                          "cpu")
    assert n == nx * ny * nz and indptr[0] == 0
    assert indptr[-1] == len(indices) == len(data) \
        == hpcg.expected_nnz(nx, ny, nz)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert np.all(data[rows == indices] == 26.0)
    assert np.all(data[rows != indices] == -1.0)
    dense = np.zeros((n, n))
    dense[rows, indices] = data
    assert np.array_equal(dense, dense.T)
    for r in range(n):  # sorted, distinct columns
        assert np.all(np.diff(indices[indptr[r]:indptr[r + 1]]) > 0)


def test_stencil_interior_rows_have_27():
    n, indptr, _, _ = hpcg.build({"nx": 4, "ny": 4, "nz": 4}, "cpu")
    assert np.diff(indptr).max() == 27 and np.diff(indptr).min() == 8


def test_hpcg_104_counts():
    assert hpcg.expected_nnz(104, 104, 104) == 29_791_000


def test_kronecker_graph():
    n, indptr, indices, data = kronecker.build(KRON, "cpu")
    assert n == 256 and len(indices) == indptr[-1] and np.all(data == 1.0)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    assert not np.any(rows == indices)  # no self-loops
    keys = rows * n + indices
    assert len(np.unique(keys)) == len(keys)  # no duplicates
    assert set(keys) == set(indices.astype(np.int64) * n + rows)  # symmetric
    # about edgefactor * n edges, each stored both ways
    assert len(keys) <= 2 * KRON["edgefactor"] * n
    assert len(keys) > KRON["edgefactor"] * n


def test_kronecker_is_one_graph_per_seed():
    a = kronecker.build(KRON, "cpu")
    b = kronecker.build(KRON, "cpu")
    c = kronecker.build(dict(KRON, seed=6), "cpu")
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])


def test_kronecker_edge_count():
    i, j = kronecker.edges(KRON, "cpu")
    assert i.numel() == j.numel() == 16 * 256
    assert int(i.min()) >= 0 and int(max(i.max(), j.max())) < 256
