"""The port's server: the CLI runs on the CPU; in process the served SpMV
batch equals the reference backend's result, and paged decode passes its
parity and steady-state gates with per-layer plans equal to `repro`'s."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import paged_kv as jp
from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
    clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--spmv", "banded",
         "--spmv-rows", "512", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "spmv-serve: banded 512x512" in proc.stdout
    assert "-> reference on cpu" in proc.stdout
    assert "SpMV/s" in proc.stdout


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_serve_in_process_returns_the_served_batch(backend, capsys):
    args = serve.build_parser().parse_args(
        ["--spmv", "random", "--spmv-rows", "300", "--batch", "6",
         "--requests", "2", "--device", "cpu", "--backend", backend])
    out = serve.serve_spmv(args)
    text = capsys.readouterr().out
    assert f"-> {backend} on cpu" in text and "matmat:" in text
    eng = out["engine"]
    assert eng.backend_resolved == backend
    assert out["y"].shape == (300, 6)
    assert out["spmv_per_s"] > 0 and out["gflops"] > 0
    ref = SpMVEngine(out["csr"], backend="reference", device="cpu")
    want = ref.matmat(out["batch"])
    if backend == "reference":
        assert torch.equal(out["y"], want)
    else:
        np.testing.assert_allclose(out["y"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.build_parser().parse_args(["--spmv", "banded",
                                            "--spmv-rows", "64"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_spmv(args)


def test_paged_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3-8b", "--reduced", "--paged", "--decode-steps", "3",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "paged-serve: llama3-8b (reduced) layers=4" in proc.stdout
    assert "steady-state=0" in proc.stdout and "tok/s" in proc.stdout


@pytest.mark.parametrize("backend", ["auto", "reference", "cuda"])
def test_serve_paged_in_process_matches_repro_plans(backend, capsys):
    argv = ["--arch", "llama3-8b", "--reduced", "--paged", "--batch", "3",
            "--prompt-len", "9", "--decode-steps", "4", "--page-block", "4",
            "--device", "cpu", "--backend", backend]
    out = serve.run(serve.build_parser().parse_args(argv))
    text = capsys.readouterr().out
    assert "paged-serve: llama3-8b (reduced) layers=4" in text
    assert out["max_err"] <= 1e-5 and out["builds_warm"] == 0
    assert out["tok_per_s"] > 0
    cfg = j_get_arch("llama3-8b").reduced()
    assert len(out["caches"]) == len(out["reports"]) == cfg.n_layers
    max_len = 9 + 4
    cache = out["caches"][0]
    assert cache.lengths.tolist() == [max_len] * 3
    assert tuple(cache.k_pages.shape) == (3 * 4, 4, cfg.n_kv_heads,
                                          cfg.resolved_head_dim)
    want = jp.kv_plan_report(jp.alloc_paged(
        n_pages=3 * 4, block=4, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, batch=3, max_len=max_len,
        dtype=jnp.float32))
    resolved = "coalesced" if backend != "cuda" else "cuda"
    for rep in out["reports"]:
        assert rep["backend_resolved"] == resolved
        for key in ("n_indices", "wide_accesses", "coalesce_rate",
                    "n_windows", "max_warps", "gather_perf"):
            assert rep[key] == want[key], key
        assert rep["metadata"]["meta_bytes"] == want["metadata"]["meta_bytes"]


def test_serve_paged_draws_in_repro_order():
    """One (L, 2, B, n_kv, hd) draw per token is the sequence of a k and a v
    draw per layer, so the caches hold what `repro`'s serve appends."""
    argv = ["--arch", "llama3-8b", "--reduced", "--paged", "--batch", "2",
            "--prompt-len", "3", "--decode-steps", "1", "--device", "cpu",
            "--seed", "5"]
    out = serve.run(serve.build_parser().parse_args(argv))
    cfg = j_get_arch("llama3-8b").reduced()
    rng = np.random.default_rng(5)
    shape = (2, cfg.n_kv_heads, cfg.resolved_head_dim)
    for pos in range(3):
        for li in range(cfg.n_layers):
            k = rng.standard_normal(shape).astype(np.float32)
            v = rng.standard_normal(shape).astype(np.float32)
            cache = out["caches"][li]
            pages = cache.page_table[:, pos // cache.block].long()
            assert torch.equal(cache.k_pages[pages, pos % cache.block],
                               torch.as_tensor(k))
            assert torch.equal(cache.v_pages[pages, pos % cache.block],
                               torch.as_tensor(v))


def test_serve_mode_selection():
    parse = serve.build_parser().parse_args
    out = serve.run(parse(["--arch", "llama3-8b", "--reduced", "--tokens",
                           "2", "--batch", "1", "--device", "cpu"]))
    assert tuple(out["tokens"].shape) == (1, 2)  # --arch alone generates
    with pytest.raises(ValueError, match="not both"):
        serve.run(parse(["--spmv", "banded", "--arch", "llama3-8b"]))
    with pytest.raises(ValueError, match="--spmv FAMILY or --arch"):
        serve.run(parse([]))


def test_generate_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "tinyllama-1.1b", "--reduced", "--tokens", "8", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "generate: tinyllama-1.1b (reduced) layers=4" in proc.stdout
    assert "generated (4, 8) in" in proc.stdout
    assert "tok/s batched); prefill" in proc.stdout
    assert "ms/step over 8 steps" in proc.stdout


@pytest.mark.parametrize("arch", ["whisper-large-v3", "zamba2-1.2b"])
def test_serve_generate_in_process(arch, capsys):
    """The served tokens are `generate`'s on the returned weights and
    prompts (whisper: the encoder's output primes the cache); one prefill
    and --tokens decode steps are timed; the draws follow --seed."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--tokens", "3", "--device", "cpu", "--seed", "4"]
    out = serve.run(serve.build_parser().parse_args(argv))
    text = capsys.readouterr().out
    assert f"generate: {arch} (reduced)" in text
    assert "generated (2, 3) in" in text and "over 3 steps" in text
    assert out["prefill_ms"] > 0 and out["decode_ms_per_step"] > 0
    assert out["tok_per_s"] > 0
    again = serve.generate(out["model"], out["params"],
                           out["batch"]["tokens"], max_new_tokens=3,
                           rt=out["rt"], extras_batch=out["batch"])
    assert torch.equal(again, out["tokens"])
    other = serve.run(serve.build_parser().parse_args(argv[:-1] + ["5"]))
    assert not torch.equal(other["batch"]["tokens"], out["batch"]["tokens"])


def test_generate_samples_with_its_generator():
    out = serve.run(serve.build_parser().parse_args(
        ["--arch", "smollm-360m", "--reduced", "--batch", "2", "--tokens",
         "2", "--device", "cpu"]))

    def sample(seed):
        return serve.generate(out["model"], out["params"],
                              out["batch"]["tokens"], max_new_tokens=5,
                              rt=out["rt"], greedy=False,
                              generator=torch.Generator().manual_seed(seed))

    a, b = sample(1), sample(1)
    assert torch.equal(a, b) and a.shape == (2, 5)
    assert int(a.max()) < out["config"].vocab_size


def test_serve_generate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.build_parser().parse_args(["--arch", "tinyllama-1.1b",
                                            "--reduced"])
    assert args.device == "cuda" and args.tokens == 32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(args)


def test_serve_paged_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.build_parser().parse_args(["--arch", "llama3-8b",
                                            "--reduced", "--paged"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(args)


# ---------------------------------------------------------------------------
# --solve, --stream, --schedule-cache / --assert-warm-cache and --chaos
# ---------------------------------------------------------------------------


def _parse(argv):
    return serve.build_parser().parse_args(argv + ["--device", "cpu"])


@pytest.mark.parametrize("solve,family", [("cg", "banded"),
                                          ("jacobi", "banded"),
                                          ("pagerank", "powerlaw"),
                                          ("power", "powerlaw")])
def test_serve_solve_in_process(solve, family, capsys):
    out = serve.run(_parse(["--spmv", family, "--spmv-rows", "600",
                            "--solve", solve, "--requests", "2"]))
    text = capsys.readouterr().out
    assert f"solve-serve: {solve} on {family} 600x600" in text
    assert "schedule_builds=1, loop=while" in text and "iters/s" in text
    assert out["tol"] == serve.SOLVE_TOLS[solve]
    cold, warm = out["cold"], out["warm"]
    assert cold.schedule_builds == 1 and len(warm) == 2
    assert all(r.converged and r.schedule_builds == 0 for r in warm)
    assert torch.equal(cold.x, warm[0].x)
    if solve == "pagerank":
        assert abs(float(cold.x.sum()) - 1.0) <= 1e-5


def test_serve_solve_gates(monkeypatch):
    # power iteration on the non-symmetric banded family does not converge
    with pytest.raises(SystemExit, match="did not converge"):
        serve.run(_parse(["--spmv", "banded", "--spmv-rows", "600",
                          "--solve", "power", "--requests", "1"]))
    from repro_torch.core import solvers

    real = solvers.cg

    def rebuilding_cg(*args, **kwargs):
        res = real(*args, **kwargs)
        res.schedule_builds = 1
        return res

    monkeypatch.setattr(solvers, "cg", rebuilding_cg)
    with pytest.raises(SystemExit, match="plan-reuse violation"):
        serve.run(_parse(["--spmv", "banded", "--spmv-rows", "300",
                          "--solve", "cg", "--requests", "1"]))
    with pytest.raises(ValueError, match="--solve requires --spmv"):
        serve.run(_parse(["--arch", "llama3-8b", "--paged", "--solve",
                          "cg"]))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_serve_stream_in_process(backend, capsys):
    out = serve.run(_parse(["--spmv", "banded", "--spmv-rows", "700",
                            "--batch", "9", "--requests", "3", "--backend",
                            backend, "--stream", "depth=2,microbatch=4"]))
    text = capsys.readouterr().out
    assert "stream: depth=2 microbatch=4 — model predicts" in text
    assert "stream parity vs sync matmat: max_abs_err=0.00e+00" in text
    assert "streamed the same 3 batches" in text
    assert out["staging"]["microbatches"] == 3 * 3
    eng = out["engine"]
    assert torch.equal(out["y_stream"], out["y"])
    for B, got in zip(out["batches"], out["stream_outs"]):
        assert torch.equal(got, eng.matmat(B))
    assert out["stream_spmv_per_s"] > 0
    assert out["stream_pred"]["speedup"] >= 1.0


def test_serve_schedule_cache_and_warm_assertion(tmp_path, capsys):
    argv = ["--spmv", "random", "--spmv-rows", "500", "--batch", "3",
            "--requests", "1", "--schedule-cache", str(tmp_path / "warm")]
    cold = serve.run(_parse(argv))
    assert cold["cache_stats"]["built"] == 1
    assert cold["cache_stats"]["disk_saves"] == 1
    clear_engine_cache()
    clear_schedule_cache()
    warm = serve.run(_parse(argv + ["--assert-warm-cache"]))
    assert warm["cache_stats"]["built"] == 0
    assert warm["cache_stats"]["disk_hits"] == 1
    assert torch.equal(warm["y"], cold["y"])
    assert "warm-cache assertion OK: zero cold plans (disk_hits=1)" in \
        capsys.readouterr().out
    clear_engine_cache()
    clear_schedule_cache()
    with pytest.raises(SystemExit, match="expected zero cold plans"):
        serve.run(_parse(argv[:-1] + [str(tmp_path / "cold"),
                                      "--assert-warm-cache"]))


CHAOS = "store_read:rate=1,count=1;store_write:count=1;" \
        "dispatch_timeout:after=1,count=1"


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_serve_chaos_heals_every_fault(tmp_path, backend, capsys):
    argv = ["--spmv", "banded", "--spmv-rows", "600", "--batch", "8",
            "--requests", "2", "--backend", backend, "--stream",
            "depth=2,microbatch=4", "--schedule-cache", str(tmp_path)]
    free = serve.run(_parse(argv))  # leaves a warm plan file to corrupt
    clear_engine_cache()
    clear_schedule_cache()
    out = serve.run(_parse(argv + ["--chaos", CHAOS]))
    text = capsys.readouterr().out
    rep = out["chaos"]
    assert rep["injected"] == 3 and rep["unrecovered"] == 0
    assert all(s["injected"] == 1 for s in rep["sites"].values())
    assert "chaos: all injected faults recovered" in text
    assert out["chaos_err"] == 0.0 and torch.equal(out["y"], free["y"])
    assert out["stream_err"] <= (0.0 if backend == "reference" else 1e-5)


def test_serve_chaos_gates(tmp_path):
    argv = ["--spmv", "banded", "--spmv-rows", "300", "--batch", "2",
            "--requests", "1"]
    with pytest.raises(SystemExit, match="injected no faults"):
        serve.run(_parse(argv + ["--chaos", "shard_fail:count=1"]))
    # every write attempt fails: the plan degrades to memory, unhealed
    with pytest.raises(SystemExit, match="were not recovered"):
        serve.run(_parse(argv + ["--schedule-cache", str(tmp_path),
                                 "--chaos", "store_write:rate=1"]))
    with pytest.raises(SystemExit) as info:
        serve.main(argv + ["--device", "cpu", "--chaos", "nosuch:rate=1"])
    assert info.value.code == 2  # argparse's usage error


def test_serve_paged_chaos_store_drill(tmp_path, capsys):
    argv = ["--arch", "llama3-8b", "--reduced", "--paged", "--batch", "2",
            "--prompt-len", "5", "--decode-steps", "2", "--page-block", "4",
            "--schedule-cache", str(tmp_path), "--chaos",
            "store_read:rate=1,count=1"]
    out = serve.run(_parse(argv))
    assert out["store_drill"] == "quarantined + re-persisted"
    assert out["chaos"]["injected"] == 1 and out["chaos"]["unrecovered"] == 0
    assert "chaos store drill: gather plan round-trip quarantined" in \
        capsys.readouterr().out
    names = os.listdir(tmp_path)
    assert any(n.endswith(".npz") for n in names)
    assert any(n.endswith(".bad") for n in names)


def test_serve_cli_solve_and_gate_exit_codes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--requests", "1", "--spmv-rows", "400", "--solve"]
    ok = subprocess.run(base + ["cg", "--spmv", "banded"], cwd=ROOT,
                        env=env, capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "converged=True" in ok.stdout
    bad = subprocess.run(base + ["power", "--spmv", "banded"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode == 1 and "did not converge" in bad.stderr


# --tune / --tune-cache, --mesh / --partition and shard_fail chaos


def test_serve_tune_model_cold_then_warm(tmp_path, capsys):
    from repro_torch.core.tune import clear_tune_cache

    clear_tune_cache()
    argv = ["--spmv", "banded", "--spmv-rows", "512", "--batch", "8",
            "--requests", "2", "--tune", "--tune-cache", str(tmp_path)]
    cold = serve.run(_parse(argv))
    clear_tune_cache()  # a new process: the winner comes from the file
    clear_engine_cache()
    clear_schedule_cache()
    warm = serve.run(_parse(argv))
    text = capsys.readouterr().out
    assert (cold["tuned"].source, cold["tuned"].trials) == ("search", 216)
    assert (warm["tuned"].source, warm["tuned"].trials) == ("disk", 0)
    assert "mode=model, source=search, trials=216" in text
    assert "mode=model, source=disk, trials=0" in text
    for out in (cold, warm):
        eng, t = out["engine"], out["tuned"]
        assert (eng.cols_per_chunk, eng.block_rows, eng.buffer_depth) == (
            t.cols_per_chunk, t.block_rows, t.buffer_depth)
    assert torch.equal(cold["y"], warm["y"])
    assert [n for n in os.listdir(tmp_path) if n.startswith("tune-")]


@pytest.mark.parametrize("partition", ["auto", "even", "nnz", "cost",
                                       "cost2d"])
@pytest.mark.parametrize("mesh", ["1,1", "2,1"])
def test_serve_mesh_in_process(mesh, partition, capsys):
    argv = ["--spmv", "powerlaw", "--spmv-rows", "700", "--batch", "6",
            "--requests", "2", "--mesh", mesh, "--partition", partition]
    out = serve.run(_parse(argv))
    text = capsys.readouterr().out
    eng, rep = out["engine"], out["report"]
    n_data = int(mesh[0])
    assert eng.n_shards == n_data == len(rep["shards"])
    strategy = "cost" if partition == "auto" else partition
    assert f"partition: {strategy} imbalance=" in text
    assert f"mesh: data={n_data} model=1" in text
    assert text.count("    shard ") == n_data
    assert "per-device throughput (1 active devices)" in text
    assert list(out["per_device_gflops"]) == ["cpu:0"]
    single = SpMVEngine(out["csr"], backend="reference", device="cpu")
    assert torch.equal(out["y"], single.matmat(out["batch"]))


def test_serve_mesh_composes_with_stream_and_the_store(tmp_path, capsys):
    argv = ["--spmv", "banded", "--spmv-rows", "600", "--batch", "8",
            "--requests", "2", "--mesh", "2,1", "--stream",
            "depth=2,microbatch=3", "--schedule-cache", str(tmp_path)]
    cold = serve.run(_parse(argv))
    assert cold["cache_stats"]["built"] == 2
    assert cold["stream_err"] == 0.0
    clear_engine_cache()
    clear_schedule_cache()
    warm = serve.run(_parse(argv + ["--assert-warm-cache"]))
    text = capsys.readouterr().out
    assert warm["cache_stats"]["built"] == 0
    assert "schedules_cached=2/2" in text
    assert torch.equal(warm["y"], cold["y"])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_serve_mesh_chaos_shard_fail_recovers(backend, capsys):
    argv = ["--spmv", "powerlaw", "--spmv-rows", "700", "--batch", "4",
            "--requests", "2", "--mesh", "2,1", "--backend", backend,
            "--chaos", "shard_fail:after=1,count=1"]
    out = serve.run(_parse(argv))
    text = capsys.readouterr().out
    rep = out["chaos"]
    assert rep["injected"] == 1 and rep["unrecovered"] == 0
    assert rep["sites"]["shard_fail"]["recovered"] == 1
    assert "chaos: all injected faults recovered" in text
    assert "recovery: recovered=1 injected=1" in text
    # the second shard of the first batch failed and was recomputed
    (ev,) = out["engine"].recovery_report()["events"]
    assert ev["shard"] == 1 and ev["injected"]
    assert out["chaos_err"] <= (0.0 if backend == "reference" else 1e-5)


def test_serve_mesh_exits_on_recovery_not_injected(monkeypatch):
    """A shard recomputed after a failure nobody injected fails the serve:
    its SpMV/s would not be the kernels'."""
    from repro_torch.core.dist import ShardedSpMVEngine

    monkeypatch.setattr(
        ShardedSpMVEngine, "recovery_report",
        lambda self: {"events": [{"injected": False}], "recovered": 1,
                      "injected": 0})
    argv = ["--spmv", "banded", "--spmv-rows", "300", "--batch", "2",
            "--requests", "1", "--mesh", "2,1"]
    with pytest.raises(SystemExit, match="not injected"):
        serve.run(_parse(argv))


def test_serve_cli_mesh_chaos_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--spmv",
         "banded", "--spmv-rows", "400", "--batch", "4", "--requests", "2",
         "--mesh", "2,1", "--partition", "nnz", "--device", "cpu",
         "--chaos", "shard_fail:after=1,count=1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "shard_fail: events=" in proc.stdout
    assert "chaos: all injected faults recovered" in proc.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--spmv",
         "banded", "--spmv-rows", "400", "--mesh", "3", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert bad.returncode != 0 and "two positive ints" in bad.stderr
