"""The check fails the control and the faults a cell can have, at sizes a
test run holds: the reference in bfloat16 in the port's place, the port's
own bfloat16 values where they are not exact, and the timed path broken
underneath (`repro_torch` patched) while the rest of a run goes on."""
import pytest
import torch

from portbench import control
from portbench.tests import small

SOLVES = ("hpcg-104.cg", "graph500-s16.pagerank")
MATMATS = ("hpcg-104.spmm64", "graph500-s16.spmm64")


def _compared(line):
    """The cell's own number (not the counts of failures)."""
    name = [k for k in line["checks"] if k not in ("raised", "unconverged")]
    assert len(name) == 1
    c = line["checks"][name[0]]
    return c["value"], c["limit"]


@pytest.mark.parametrize("name", small.CELLS)
def test_reference_bf16_is_not_correct(name):
    line = small.run(name, port=control.ReferenceLow("cpu"), seconds=0.2)
    value, limit = _compared(line)
    assert line["correct"] is False and value > limit


@pytest.mark.parametrize("name", ["graph500-s16.pagerank",
                                  "graph500-s16.spmm64"])
def test_port_bf16_is_not_correct_where_values_round(name):
    line = small.run(name, port=control.make_port("port-bf16", "cpu"))
    value, limit = _compared(line)
    assert line["correct"] is False and value > limit


def test_port_bf16_is_exact_on_the_stencil():
    # 26 and -1 are bfloat16 numbers: the port's bf16 path computes the
    # same products, so it is no control on hpcg-104 (see PERF.md)
    line = small.run("hpcg-104.spmm64",
                     port=control.make_port("port-bf16", "cpu"))
    assert line["correct"] is True


def _alter_kernel_output(monkeypatch):
    """Every SpMV/SpMM the kernels produce has one entry altered."""
    from repro_torch.kernels import ops

    for name in ("sell_spmv", "sell_spmm"):
        real = getattr(ops, name)

        def altered(*a, _real=real, **kw):
            y = _real(*a, **kw).clone()
            y.view(-1)[0] += 1.0
            return y

        monkeypatch.setattr(ops, name, altered)


@pytest.mark.parametrize("name", small.CELLS)
def test_fault_answer_altered(monkeypatch, name):
    _alter_kernel_output(monkeypatch)
    assert small.run(name, maxiter=30)["correct"] is False


@pytest.mark.parametrize("name", SOLVES)
def test_fault_step_leaves_state_unchanged(monkeypatch, name):
    from repro_torch.core import solvers

    def commit_counter_only(state, new, active, maxiter):
        new.pop("trace")
        state["k"].copy_(state["k"] + 1)

    monkeypatch.setattr(solvers, "_commit", commit_counter_only)
    line = small.run(name, seconds=0.1, maxiter=30)
    assert line["correct"] is False
    assert line["checks"]["unconverged"]["value"] > 0


@pytest.mark.parametrize("name", MATMATS)
def test_fault_half_the_batch_left_out(monkeypatch, name):
    from repro_torch.kernels import ops

    real = ops.sell_spmm

    def half(colidx, values, X, **kw):
        k = X.shape[1]
        Y = real(colidx, values, X[:, : k // 2].contiguous(), **kw)
        return torch.cat([Y, torch.zeros(Y.shape[0], k - k // 2,
                                         dtype=Y.dtype)], dim=1)

    monkeypatch.setattr(ops, "sell_spmm", half)
    assert small.run(name)["correct"] is False


def test_fault_that_raises_counts_as_failed(monkeypatch):
    from repro_torch.core.engine import SpMVEngine

    real = SpMVEngine.matmat
    calls = []

    def boom(self, X):  # the warm-up's call passes, the window's raise
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("injected")
        return real(self, X)

    monkeypatch.setattr(SpMVEngine, "matmat", boom)
    line = small.run("hpcg-104.spmm64", seconds=0.1)
    assert line["correct"] is False and line["failed"] == line["attempted"]


def test_readings_cli_shape():
    out = control.readings(small.cell("hpcg-104.cg"), [1, 2], 0.1, "port",
                           "cpu")
    assert [r["seed"] for r in out] == [1, 2]
    assert all(r["correct"] for r in out)
    assert set(out[0]["checks"]) == {"raised", "unconverged",
                                     "true_residual"}
