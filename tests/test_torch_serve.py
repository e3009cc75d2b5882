"""The port's SpMV server: the CLI runs on the CPU, and in process its
served batch equals the reference backend's result."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engine import SpMVEngine, clear_engine_cache, \
    clear_schedule_cache
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
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
