"""One sharded update of every other reduced family on a 2x2 grid of four
gloo ranks (`train.grid.family_cases`), held by `train.grid.update_errors`
to `repro`'s jitted single-device `make_train_step` on the same numpy
parameters and batch, drawn by `repro` (the loss, the gradients, the
update and both moments), and to the port's own single-device update on
them (`train.grid.port_reference`). The families are those whose step runs
code only the grid runs: the MoE families (the dispatch's replicated
region), whisper, the VLM, the other dense decoders, zamba2 (its sequence
padding) and xlstm (``keep_only`` before the mLSTM's head merges, the
``log_sigmoid_backward`` and ``flip`` rules the port registers). One
process grid serves the module. The launcher runs under
``torch.distributed.run`` on the same 2x2 shape."""
import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro.models import lm_loss as j_lm_loss
from repro.models import make_input_batch as j_make_input_batch
from repro.models.transformer import Runtime as JRuntime
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.launch.mesh import free_port, run_grid
from repro_torch.train.grid import FAMILY_BATCH, family_cases, \
    port_reference, run_cases, update_errors

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
NAMES = ["deepseek-v2-lite-16b", "llama-3.2-vision-11b", "llama3-8b",
         "llama4-maverick-400b-a17b", "qwen2-1.5b", "whisper-large-v3",
         "xlstm-1.3b", "zamba2-1.2b"]


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _repro(name):
    """`repro`'s reduced model, numpy parameters and a batch of
    `train.grid.FAMILY_BATCH`."""
    jcfg = J_ARCHS[name].reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    jbatch = j_make_input_batch(jcfg, *FAMILY_BATCH,
                                key=jax.random.PRNGKey(1))
    return jmodel, _np(jparams), {k: np.asarray(v)
                                  for k, v in jbatch.items()}


def _repro_reference(name):
    """`repro`'s jitted loss, gradients and one `make_train_step` on its
    inputs, in `update_errors`' keys."""
    jmodel, params, batch = _repro(name)
    step = j_make_train_step(jmodel, JOptConfig(), JRuntime())

    def both(p, o, b):  # one compilation
        return jax.value_and_grad(
            lambda q: j_lm_loss(jmodel, q, b, JRuntime()))(p), step(p, o, b)

    (loss, grads), (jp, jo, jm) = jax.jit(both)(
        params, j_init_opt_state(params), batch)
    return {"loss": float(loss), "grads": _np(grads),
            "update_loss": float(jm["loss"]),
            "grad_norm": float(jm["grad_norm"]), "params": _np(jp),
            "opt": (_np(jo.mu), _np(jo.nu), np.asarray(jo.step))}


@pytest.fixture(scope="module")
def grid():
    """{family: (case, results by rank, `repro`'s reference)}: the
    references are compiled while the ranks run."""
    cases = family_cases({name: _repro(name)[1:] for name in NAMES})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_grid, run_cases, WORLD, (cases,),
                            timeout=900)
        refs = [_repro_reference(name) for name in NAMES]
        by_rank = ranks.result()
    return {case["arch"]: (case, [r[i] for r in by_rank], ref)
            for i, (case, ref) in enumerate(zip(cases, refs))}


def _on_every_rank(results):
    for key in ("loss", "update_loss", "grad_norm"):
        assert {r[key] for r in results} == {results[0][key]}, key
    assert results[0]["moment_dtensors"] == ["DTensor"]


@pytest.mark.parametrize("name", NAMES)
def test_update_on_2x2_matches_repro_single_device(grid, name):
    _, results, ref = grid[name]
    _on_every_rank(results)
    errs = update_errors(results[0], ref)
    assert max(errs.values()) <= 1, errs


@pytest.mark.parametrize("name", NAMES)
def test_update_on_2x2_matches_the_single_device_port(grid, name):
    case, results, _ = grid[name]
    _on_every_rank(results)
    errs = update_errors(results[0], port_reference(case))
    assert max(errs.values()) <= 1, errs


def test_launch_train_on_a_2x2_grid_prints_json_once():
    """``torch.distributed.run`` of the launcher with ``--mesh 2,2
    --device cpu``: four gloo ranks train, rank 0 prints `repro`'s JSON
    once."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(WORLD), "--master-port", str(free_port()), "-m",
         "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
         "--reduced", "--mesh", "2,2", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "16"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count('"history"') == 1
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert out["mesh"] == {"data": 2, "model": 2}
    assert all(np.isfinite(h["loss"]) for h in out["history"])
