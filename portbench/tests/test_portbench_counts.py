"""The yardstick's byte and FLOP counts and its reference against the
port's plain kernels."""
import numpy as np
import pytest
import torch

from portbench import reference, roofline
from portbench.generators import hpcg, kronecker

H100 = "NVIDIA H100 80GB HBM3"


def test_spmv_counts():
    assert roofline.spmv_bytes(10, 3, 4) == 10 * 8 + 7 * 4
    assert roofline.spmv_flops(10) == 20


def test_spmm_counts():
    assert roofline.spmm_bytes(10, 3, 4, 64) == 80 + 7 * 64 * 4
    assert roofline.spmm_flops(10, 64) == 1280


def test_hpcg_104_spmv_least_time():
    nbytes = roofline.spmv_bytes(29_791_000, 1_124_864, 1_124_864)
    assert nbytes == 247_326_912
    t = roofline.least_seconds(nbytes, roofline.spmv_flops(29_791_000), H100)
    assert t == pytest.approx(nbytes / 3.35e12)


def test_least_time_takes_the_larger_bound():
    # 1 byte, many FLOPs: bound by the float32 peak
    assert roofline.least_seconds(1, 67e12, H100) == pytest.approx(1.0)
    assert roofline.least_seconds(1, 1, "cpu") is None
    assert roofline.hbm_share(3.35e12, 1.0, H100) == pytest.approx(100.0)
    assert roofline.hbm_share(1, 0.0, H100) is None


def _port_engine(n, indptr, indices, data, operator):
    from repro_torch.core import solvers
    from repro_torch.core.engine import get_engine
    from repro_torch.core.formats import CSRMatrix

    A = CSRMatrix(n, n, indptr, indices, data)
    if operator == "transition":
        A = solvers.transition_matrix(A)
    return get_engine(A, device="cpu", backend="cuda")


@pytest.mark.parametrize("which", ["hpcg", "kronecker"])
def test_reference_against_port_plain_kernels(which):
    if which == "hpcg":
        n, indptr, indices, data = hpcg.build({"nx": 5, "ny": 6, "nz": 7},
                                              "cpu")
        operator = "matrix"
    else:
        n, indptr, indices, data = kronecker.build(
            {"scale": 8, "edgefactor": 16, "A": .57, "B": .19, "C": .19,
             "seed": 3}, "cpu")
        operator = "transition"
    op = reference.Operator(n, indptr, indices, data, kind=operator,
                            device="cpu")
    eng = _port_engine(n, indptr, indices, data, operator)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, generator=g)
    X = torch.randn(n, 64, generator=g)
    want, scale = op.apply(x), op.apply(x, absolute=True)
    got = eng.matvec(x).to(torch.float64)
    assert torch.all((got - want).abs() <= 1e-6 * scale + 1e-12)
    assert reference.spmm_error(op, X, eng.matmat(X)) < 1e-6


def test_transition_columns_sum_to_one():
    n, indptr, indices, data = kronecker.build(
        {"scale": 7, "edgefactor": 16, "A": .57, "B": .19, "C": .19,
         "seed": 1}, "cpu")
    op = reference.Operator(n, indptr, indices, data, kind="transition",
                            device="cpu")
    col_sums = op.apply(torch.eye(n, dtype=torch.float64))
    col_sums = col_sums.sum(dim=0)
    deg = np.diff(indptr)
    assert torch.allclose(col_sums[deg > 0], torch.ones(int((deg > 0).sum()),
                                                        dtype=torch.float64))
    assert torch.all(col_sums[deg == 0] == 0)


def test_reference_pagerank_is_a_fixed_point():
    n, indptr, indices, data = kronecker.build(
        {"scale": 7, "edgefactor": 16, "A": .57, "B": .19, "C": .19,
         "seed": 1}, "cpu")
    op = reference.Operator(n, indptr, indices, data, kind="transition",
                            device="cpu")
    x = reference.pagerank(op, 0.85)
    y = 0.85 * op.apply(x)
    y = y + (1 - y.sum()) / n
    assert float((y - x).abs().sum()) < 1e-12
    assert float(x.sum()) == pytest.approx(1.0, abs=1e-12)


def test_spmm_error_scale():
    op = reference.Operator(2, np.array([0, 1, 2]), np.array([0, 1]),
                            np.array([2.0, 0.0]), kind="matrix", device="cpu")
    X = torch.ones(2, 1)
    assert reference.spmm_error(op, X, torch.tensor([[2.0], [0.0]])) == 0.0
    assert reference.spmm_error(op, X, torch.tensor([[2.2], [0.0]])) \
        == pytest.approx(0.1)
    assert reference.spmm_error(op, X, torch.tensor([[2.0], [1.0]])) \
        == float("inf")
