"""The port's iterative solvers (`repro_torch.core.solvers`), held to
`repro.core.solvers`' ``loop="python"`` oracle on the same matrices and
right-hand sides.

Tolerances (float32; `torch.dot` and `jnp.vdot` sum in different orders):
- iterations equal, or within one where the deciding residual of either
  package lies within 1e-6 relative of ``tol`` (both are printed then);
- ``‖x_port − x_repro‖ ≤ 1e-4·‖x_repro‖``;
- residual traces within 1e-4 relative plus 2**-22 (two float32 roundings)
  times the scale each metric is a difference of: ‖b‖ for cg and jacobi
  (‖b − Ax‖), 1 for pagerank (the L1 delta of two distributions) and power
  iteration (‖Ax − λx‖/|λ| of a unit x). Near convergence these metrics are
  differences of nearly equal numbers, so their last digits are rounding,
  which the two packages round in different orders.

PageRank is compared at ``tol=1e-4``, where its deltas lie far above that
rounding. The port's own ``while`` and ``python`` loops agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import solvers as jsolvers
from repro.core.matrices import powerlaw as j_powerlaw, spd as j_spd
from repro_torch.core import solvers
from repro_torch.core.engine import clear_engine_cache, \
    clear_schedule_cache, get_engine
from repro_torch.core.formats import coo_to_csr
from repro_torch.core.matrices import powerlaw, spd
from repro_torch.core.runtime import StreamingExecutor

N = 240


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    yield


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


CASES = {
    "cg": dict(tol=1e-6),
    "jacobi": dict(tol=1e-6),
    "pagerank": dict(tol=1e-4),
    "power_iteration": dict(tol=1e-5, maxiter=1000),
}


def _matrices(name, seed):
    if name == "pagerank":
        return (powerlaw(N, 6)(seed=seed), j_powerlaw(N, 6)(seed=seed))
    return spd(N, 6, 0.6)(seed=seed), j_spd(N, 6, 0.6)(seed=seed)


def _run(mod, name, A, b, **kw):
    fn = getattr(mod, name)
    args = (A, b) if name in ("cg", "jacobi") else (A,)
    return fn(*args, trace=True, **{**CASES[name], **kw})


def _metric(name, res, b):
    """The quantity each solver compares with ``tol`` (last iterate)."""
    tr = np.asarray(res.residual_trace, np.float64)
    if name in ("cg", "jacobi"):
        return tr / np.linalg.norm(b.astype(np.float64))
    return tr


def _check_iterations(name, ours, theirs, b, tol):
    if ours.iterations == theirs.iterations:
        return
    assert abs(ours.iterations - theirs.iterations) == 1
    k = min(ours.iterations, theirs.iterations) - 1
    m_ours, m_theirs = _metric(name, ours, b)[k], _metric(name, theirs, b)[k]
    print(f"{name}: iterations {ours.iterations} (port) vs "
          f"{theirs.iterations} (repro); residuals {m_ours!r} vs "
          f"{m_theirs!r} at tol {tol}")
    assert min(abs(m_ours - tol), abs(m_theirs - tol)) <= 1e-6 * tol


@pytest.mark.parametrize("name", sorted(CASES))
def test_solver_matches_repro_python_oracle(name):
    A, jA = _matrices(name, 1)
    b = _rhs(N, 2)
    theirs = _run(jsolvers, name, jA, b, loop="python", backend="reference")
    results = {
        loop: _run(solvers, name, A, b, loop=loop, backend="reference",
                   device="cpu")
        for loop in ("python", "while")
    }
    ours = results["python"]
    assert ours.converged and theirs.converged
    _check_iterations(name, ours, theirs, b, CASES[name]["tol"])
    x, xj = ours.x.numpy().astype(np.float64), np.asarray(theirs.x,
                                                          np.float64)
    assert np.linalg.norm(x - xj) <= 1e-4 * np.linalg.norm(xj)
    m = min(ours.iterations, theirs.iterations)
    tr, trj = ours.residual_trace[:m], np.asarray(theirs.residual_trace)[:m]
    scale = np.linalg.norm(b) if name in ("cg", "jacobi") else 1.0
    np.testing.assert_allclose(tr, trj, rtol=1e-4, atol=2.0 ** -22 * scale)
    if name == "power_iteration":
        assert abs(ours.eigenvalue - theirs.eigenvalue) <= 1e-4 * abs(
            theirs.eigenvalue)
    # the port's while loop (blocks of guarded steps) equals its oracle
    wh = results["while"]
    assert wh.iterations == ours.iterations and wh.loop == "while"
    assert torch.equal(wh.x, ours.x)
    assert np.array_equal(wh.residual_trace, ours.residual_trace)
    assert ours.matvecs == ours.iterations + (name == "cg")
    assert wh.matvecs >= wh.iterations + (name == "cg")
    print(f"{name}: while ran {wh.matvecs} matvecs for {wh.iterations} "
          f"iterations")


@pytest.mark.parametrize("k, m, t, maxiter, last, want", [
    (0, 1.0, 1e-6, 500, None, 4),             # no rate yet: middle block
    (0, 1.0, 1e-6, 2, None, 1),               # never past maxiter
    (4, 1e-2, 1e-8, 500, (0, 1.0), 4),        # 12 steps left
    (4, 1e-2, 1e-12, 500, (0, 1.0), 16),      # 20 steps left
    (4, 1e-2, 1e-12, 10, (0, 1.0), 4),        # 20 left, 6 before maxiter
    (4, 1e-2, 2e-3, 500, (0, 1.0), 1),        # 2 steps left
    (4, 1e-2, 1e-8, 500, (0, float("inf")), 4),  # inf start: no rate
    (8, 0.5, 1e-8, 500, (4, 0.4), 4),         # metric rose: no rate
])
def test_while_block_lengths_follow_the_rate(k, m, t, maxiter, last, want):
    """Each block of the while loop is the longest of 16, 4 or 1 steps that
    the steps still needed fill, so few steps run past convergence."""
    assert solvers._next_block(k, m, t, maxiter, last) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_build_cold_none_warm(name):
    A, _ = _matrices(name, 3)
    b = _rhs(N, 4)
    cold = _run(solvers, name, A, b, backend="cuda", device="cpu")
    warm = _run(solvers, name, A, b, backend="cuda", device="cpu")
    assert (cold.schedule_builds, warm.schedule_builds) == (1, 0)
    assert cold.loop == "while" and torch.equal(cold.x, warm.x)


@pytest.mark.parametrize("name", ["cg", "jacobi"])
def test_warm_solve_takes_each_right_hand_side(name):
    A, _ = _matrices(name, 5)
    eng = get_engine(A, device="cpu")
    dense = A.todense().astype(np.float64)
    b1, b2 = _rhs(N, 6), _rhs(N, 7)
    xs = []
    for b in (b1, b2, b1):
        res = getattr(solvers, name)(eng, b, tol=1e-6, loop="while")
        assert res.converged
        x = res.x.numpy().astype(np.float64)
        assert np.linalg.norm(b - dense @ x) / np.linalg.norm(b) <= 5e-6
        xs.append(res.x)
    assert torch.equal(xs[0], xs[2]) and not torch.equal(xs[0], xs[1])


def test_pagerank_with_dangling_nodes_matches_repro():
    """Nodes without out-edges: their rank is spread by the mass
    correction, x stays a distribution, and matches repro."""
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 60, 300)
    rows = rows[rows % 5 != 0]  # every fifth node has no out-edge
    cols = rng.integers(0, 80, rows.size)
    vals = np.ones(rows.size)
    adj = coo_to_csr(80, 80, rows, cols, vals)
    from repro.core.formats import coo_to_csr as j_coo_to_csr

    jadj = j_coo_to_csr(80, 80, rows, cols, vals)
    M, jM = solvers.transition_matrix(adj), jsolvers.transition_matrix(jadj)
    for a, b in ((M.indptr, jM.indptr), (M.indices, jM.indices),
                 (M.data, jM.data)):
        np.testing.assert_array_equal(a, b)
    ours = solvers.pagerank(adj, tol=1e-5, loop="python", device="cpu",
                            backend="reference")
    theirs = jsolvers.pagerank(jadj, tol=1e-5, loop="python",
                               backend="reference")
    assert ours.converged and ours.iterations == theirs.iterations
    x = ours.x.numpy()
    assert (x >= 0).all() and abs(float(x.sum()) - 1.0) <= 1e-5
    assert np.abs(x - np.asarray(theirs.x)).max() <= 1e-6


def test_host_loop_drives_a_streaming_executor():
    A, _ = _matrices("cg", 9)
    b = _rhs(N, 10)
    eng = get_engine(A, backend="reference", device="cpu")
    streamer = StreamingExecutor(eng, microbatch=1, depth=2)
    for name in ("cg", "jacobi", "power_iteration"):
        # a streamer carries no SELL: jacobi takes the diagonal explicitly
        kw = dict(diag=solvers._diag_of(A)) if name == "jacobi" else {}
        via_stream = _run(solvers, name, streamer, b, **kw)
        via_engine = _run(solvers, name, eng, b, loop="host", **kw)
        assert via_stream.loop == "host" and via_stream.converged
        np.testing.assert_array_equal(via_stream.x, via_engine.x)
        assert via_stream.iterations == via_engine.iterations
    P = solvers.transition_matrix(powerlaw(N, 6)(seed=11))
    pr = solvers.pagerank(
        StreamingExecutor(get_engine(P, backend="reference", device="cpu")),
        tol=1e-4)
    assert pr.converged and abs(float(pr.x.sum()) - 1.0) <= 1e-5
    with pytest.raises(ValueError, match="device-resident"):
        solvers.cg(streamer, b, loop="while")


def test_operator_and_loop_errors():
    A, _ = _matrices("cg", 12)
    eng = get_engine(A, device="cpu")
    b = _rhs(N, 13)
    with pytest.raises(ValueError, match="loop must be"):
        solvers.cg(eng, b, loop="scan")
    with pytest.raises(ValueError, match="prebuilt"):
        solvers.cg(eng, b, backend="reference")
    with pytest.raises(TypeError, match="CSRMatrix"):
        solvers.cg(object(), b)
    with pytest.raises(TypeError, match="CSR adjacency"):
        solvers.pagerank(eng.sell)

    class Sharded:
        """A sharded operator: cg's host loop takes its dots per part."""
        n_rows = n_cols = N
        parts_calls = 0

        def matvec(self, x):
            return eng.matvec(x)

        def matvec_parts(self, x):
            Sharded.parts_calls += 1
            xt = torch.as_tensor(np.asarray(x, np.float32))
            return [(eng.matvec(xt)[:5], xt, (0, 5)),
                    (eng.matvec(xt)[5:], xt, (5, N))]

    res = solvers.cg(Sharded(), b)
    assert res.loop == "host" and res.converged
    assert Sharded.parts_calls == res.iterations
    np.testing.assert_array_equal(solvers._diag_of(A),
                                  solvers._diag_of(eng))
