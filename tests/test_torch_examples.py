"""The port's examples (`repro_torch.examples`) against the repo's
`examples/*.py` on the CPU (``--device cpu``): the same printed lines,
with every number that does not depend on the framework's random draws
or the clock equal (floats within 1e-5). `repro`'s three serving examples
run in one subprocess; `train_tinylm` runs at 2 steps of 2 x 32 tokens."""
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.examples import quickstart, serve_decode, spmv_pipeline, \
    train_tinylm

REPO = pathlib.Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")
SNIPPET = textwrap.dedent(
    """
    import runpy, sys
    for name in sys.argv[1:]:
        print(f"=== {name}", flush=True)
        runpy.run_path(f"examples/{name}.py", run_name="__main__")
    """
)


@pytest.fixture(scope="module")
def repro_out():
    """{example: its printed lines} of `repro`'s quickstart, spmv_pipeline
    and serve_decode."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", SNIPPET, "quickstart", "spmv_pipeline",
         "serve_decode"], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out, name = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("=== "):
            name = line[4:]
            out[name] = []
        elif line.strip():
            out[name].append(line)
    return out


def _port_lines(capsys, main):
    main(["--device", "cpu"])
    return [line for line in capsys.readouterr().out.splitlines()
            if line.strip()]


def _same_numbers(got, want, rtol=1e-5, atol=1e-5):
    """The lines' words equal and their numbers within tolerance."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), (got, want)
    for g, w in zip(NUMBER.findall(got), NUMBER.findall(want)):
        assert math.isclose(float(g), float(w), rel_tol=rtol,
                            abs_tol=atol), (got, want)


def test_quickstart_prints_repros_errors_and_coalesce_stats(repro_out,
                                                            capsys):
    got = _port_lines(capsys, quickstart.main)
    want = repro_out["quickstart"]
    assert len(got) == len(want)
    # the kernel and the gather backend are named by the port's words
    assert want[1].startswith("Pallas sell_spmv kernel")
    assert got[1].startswith("plain sell_spmv kernel")
    assert want[2] == "coalesced_gather (pallas) exact: True"
    assert got[2] == "coalesced_gather (coalesced) exact: True"
    _same_numbers(got[0], want[0])
    # the kernels' errors: two summation orders, both within 1e-5
    assert float(got[1].split()[-1]) < 1e-5
    assert float(want[1].split()[-1]) < 1e-5
    for g, w in zip(got[3:], want[3:]):
        _same_numbers(g, w)


def test_spmv_pipeline_matches_repro(repro_out, capsys):
    got = _port_lines(capsys, spmv_pipeline.main)
    want = repro_out["spmv_pipeline"]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _same_numbers(g, w, rtol=1e-4, atol=5e-4)  # |A x|/|x| at 3 places


def test_serve_decode_matches_repro(repro_out, capsys):
    got = _port_lines(capsys, serve_decode.main)
    want = repro_out["serve_decode"]
    assert len(got) == len(want) == 3
    # the dense line's seconds are the clock's; its tokens are the same
    assert got[0].split(" in ")[0] == want[0].split(" in ")[0] == \
        "dense cache: generated 4x24 tokens"
    assert got[1:] == want[1:]


def _repro_tinylm_params() -> int:
    """`repro`'s parameter count of its TINYLM_100M (from
    `jax.eval_shape`, nothing drawn)."""
    import jax
    import numpy as np

    from repro.configs.base import ArchConfig
    from repro.models import build_model

    cfg = ArchConfig(**{f: getattr(train_tinylm.TINYLM_100M, f)
                        for f in ("name", "family", "n_layers", "d_model",
                                  "n_heads", "n_kv_heads", "d_ff",
                                  "vocab_size", "tie_embeddings", "dtype")})
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_train_tinylm_runs_with_finite_losses(tmp_path, capsys):
    out = train_tinylm.main(["--steps", "2", "--batch", "2", "--seq", "32",
                             "--device", "cpu", "--ckpt-dir",
                             str(tmp_path / "ckpt")])
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == \
        f"tinylm-100m: {_repro_tinylm_params() / 1e6:.1f}M params"
    losses = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(math.isfinite(v) for v in losses)
    assert json.loads(printed[printed.index("["):printed.index("]") + 1]) \
        == out["history"]
    assert "final loss" in printed.splitlines()[-1]


@pytest.mark.parametrize("module", [quickstart, spmv_pipeline, serve_decode,
                                    train_tinylm])
def test_examples_without_a_card_raise(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])
