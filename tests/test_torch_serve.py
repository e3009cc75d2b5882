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
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        serve.run(parse(["--arch", "llama3-8b", "--device", "cpu"]))
    with pytest.raises(ValueError, match="not both"):
        serve.run(parse(["--spmv", "banded", "--arch", "llama3-8b",
                         "--paged"]))
    with pytest.raises(ValueError, match="--spmv FAMILY or --arch"):
        serve.run(parse([]))


def test_serve_paged_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.build_parser().parse_args(["--arch", "llama3-8b",
                                            "--reduced", "--paged"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(args)
