"""The port's checkpoint and fault tolerance (`repro_torch.train.checkpoint`,
`.fault_tolerance`) against `repro`'s: directories interchange (`repro` ->
port in float32 and bf16, port -> `repro` in float32) with the same leaf
names, files and bytes; `repro` cannot restore its own bf16 checkpoint
(C21) and the port restores it bit for bit; and `repro`'s checkpoint and
recovery cases, each run through both packages with the same result."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import build_model as j_build_model
from repro.optim.optimizer import OptState as JOptState
from repro.optim.optimizer import init_opt_state as j_init_opt_state
from repro.train import checkpoint as jck
from repro.train import fault_tolerance as jft
from repro_torch.configs import ARCHS
from repro_torch.core.engine import clear_engine_cache, clear_schedule_cache
from repro_torch.core.gather_engine import clear_gather_engine_cache
from repro_torch.core.interop import model_params_from_numpy, \
    model_params_to_numpy, opt_state_from_numpy, opt_state_to_numpy
from repro_torch.models import build_model
from repro_torch.optim.optimizer import init_opt_state
from repro_torch.train import checkpoint as tck
from repro_torch.train import fault_tolerance as tft

ARCH = "tinyllama-1.1b"


@pytest.fixture(autouse=True)
def _fresh_port_caches():
    clear_engine_cache()
    clear_schedule_cache()
    clear_gather_engine_cache()
    yield


@functools.lru_cache(maxsize=None)
def _repro_state(dtype):
    """`repro`'s reduced tinyllama parameters in `dtype` and an OptState
    with moments and step that are not zero, as numpy."""
    jcfg = dataclasses.replace(J_ARCHS[ARCH].reduced(), dtype=dtype)
    params = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(0))
    opt = j_init_opt_state(params)
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda m: rng.standard_normal(m.shape).astype(
        np.float32), opt.mu)
    nu = jax.tree.map(lambda m: rng.random(m.shape).astype(np.float32),
                      opt.nu)
    return (jax.tree.map(np.asarray, params),
            JOptState(mu, nu, np.asarray(7, np.int32)))


def _port_tree(dtype, seed=3):
    """A port training state of the same structure with other values."""
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   device="cpu")
    return cfg, {"params": params, "opt": init_opt_state(params)}


def _jtree(params, opt):
    return {"params": params, "opt": opt}


def _assert_tree_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _port_as_numpy(cfg, tree):
    mu, nu, step = opt_state_to_numpy(cfg, tree["opt"])
    return _jtree(model_params_to_numpy(cfg, tree["params"]),
                  JOptState(mu, nu, step))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repro_checkpoint_restores_in_the_port(tmp_path, dtype):
    params, opt = _repro_state(dtype)
    jck.save_checkpoint(tmp_path, 4, _jtree(params, opt))
    cfg, tree = _port_tree(dtype)
    step, restored = tck.restore_latest(tmp_path, tree)
    assert step == 4 and restored is tree
    _assert_tree_equal(_port_as_numpy(cfg, restored), _jtree(params, opt))


def test_port_checkpoint_restores_in_repro(tmp_path):
    params, opt = _repro_state("float32")
    cfg = ARCHS[ARCH].reduced()
    tree = {"params": model_params_from_numpy(cfg, params, device="cpu"),
            "opt": opt_state_from_numpy(cfg, opt, device="cpu")}
    tck.save_checkpoint(tmp_path, 9, tree)
    jtree = jax.tree.map(jnp.zeros_like, _jtree(params, opt))
    step, restored = jck.restore_latest(tmp_path, jtree)
    assert step == 9
    _assert_tree_equal(jax.tree.map(np.asarray, restored),
                       _jtree(params, opt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_repro_bytes(tmp_path, dtype):
    """Same values, same directory: every leaf file and the manifest are
    byte for byte `repro`'s (bf16 leaves with descr '<V2')."""
    params, opt = _repro_state(dtype)
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype)
    jck.save_checkpoint(tmp_path / "repro", 2, _jtree(params, opt))
    tck.save_checkpoint(tmp_path / "port", 2, {
        "params": model_params_from_numpy(cfg, params, device="cpu"),
        "opt": opt_state_from_numpy(cfg, opt, device="cpu")})
    a, b = tmp_path / "repro" / "step_00000002", \
        tmp_path / "port" / "step_00000002"
    files = sorted(p.name for p in a.iterdir())
    assert files == sorted(p.name for p in b.iterdir())
    for name in files:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    manifest = json.loads((b / tck.MANIFEST).read_text())
    dtypes = {e["dtype"] for e in manifest["leaves"]}
    assert dtypes == ({"float32", "int32"} | ({dtype}))


def test_c21_repro_cannot_restore_its_own_bf16_the_port_can(tmp_path):
    params, opt = _repro_state("bfloat16")
    jck.save_checkpoint(tmp_path, 1, _jtree(params, opt))
    with pytest.raises(TypeError, match="V2"):
        jck.restore_latest(tmp_path, _jtree(params, opt))
    cfg, tree = _port_tree("bfloat16")
    tck.restore_latest(tmp_path, tree)
    got = model_params_to_numpy(cfg, tree["params"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert g.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(g.view(np.int16), w.view(np.int16))


def test_restore_refuses_other_shapes_and_dtypes(tmp_path):
    tck.save_checkpoint(tmp_path, 0, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.restore_latest(tmp_path, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        tck.restore_latest(tmp_path, {"w": torch.zeros(4, dtype=torch.int32)})


# --------------------------------------------------------------------------
# `repro`'s checkpoint and fault-tolerance cases, through both packages
# --------------------------------------------------------------------------

PKGS = {
    "repro": (jck, jft, lambda a: jnp.asarray(a)),
    "port": (tck, tft, lambda a: torch.from_numpy(np.array(a))),
}


def _small(lib, step):
    return {"w": lib(np.full((4, 4), float(step), np.float32)),
            "nested": {"b": lib(np.arange(3, dtype=np.int32) + step)}}


def _case_roundtrip(ck, lib, tmp_path):
    ck.save_checkpoint(tmp_path, 7, _small(lib, 7))
    step, tree = ck.restore_latest(tmp_path, _small(lib, 0))
    return step, np.asarray(tree["w"]).tolist(), \
        np.asarray(tree["nested"]["b"]).tolist()


def _case_skips_incomplete(ck, lib, tmp_path):
    ck.save_checkpoint(tmp_path, 1, _small(lib, 1))
    ck.save_checkpoint(tmp_path, 2, _small(lib, 2))
    (tmp_path / "step_00000002" / "manifest.json").unlink()
    return ck.restore_latest(tmp_path, _small(lib, 0))[0]


def _case_gc(ck, lib, tmp_path):
    for s in range(6):
        ck.save_checkpoint(tmp_path, s, _small(lib, s), keep=2)
    return [s for s, _ in ck.list_checkpoints(tmp_path)]


def _case_structure_mismatch(ck, lib, tmp_path):
    ck.save_checkpoint(tmp_path, 0, _small(lib, 0))
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore_latest(tmp_path, {"other": lib(np.zeros(2, np.float32))})
    return "raised"


def _case_async(ck, lib, tmp_path):
    saver = ck.AsyncCheckpointer(tmp_path)
    saver.save(3, _small(lib, 3))
    saver.wait()
    return [s for s, _ in ck.list_checkpoints(tmp_path)]


CHECKPOINT_CASES = {
    "roundtrip": (_case_roundtrip,
                  (7, np.full((4, 4), 7.0).tolist(), [7, 8, 9])),
    "restore_skips_incomplete": (_case_skips_incomplete, 1),
    "gc_keeps_latest": (_case_gc, [4, 5]),
    "structure_mismatch_raises": (_case_structure_mismatch, "raised"),
    "async_checkpointer": (_case_async, [3]),
}


@pytest.mark.parametrize("case", sorted(CHECKPOINT_CASES))
def test_checkpoint_cases_as_repro(tmp_path, case):
    fn, want = CHECKPOINT_CASES[case]
    for pkg, (ck, _, lib) in PKGS.items():
        assert fn(ck, lib, tmp_path / pkg) == want, pkg


def _counting_step(pkg, fail_at=(), failed=None):
    """step_fn recording per-step effects; raises once per step in
    fail_at."""
    failed = set() if failed is None else failed

    def step_fn(state, step):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"injected failure at step {step}")
        if pkg == "repro":
            hist = state["hist"].at[step].add(1)
        else:
            hist = state["hist"].clone()
            hist[step] += 1
        return {"x": state["x"] + 1, "hist": hist}

    return step_fn


def _init(pkg):
    lib = PKGS[pkg][2]
    return lambda: {"x": lib(np.zeros((), np.float32)),
                    "hist": lib(np.zeros(32, np.float32))}


RECOVERY_CASES = {
    # (kwargs, injected failures, expected hist[:total], expected x)
    "resumes_after_failure": (dict(total_steps=12, ckpt_every=3), (7,)),
    "replays_only_since_last_checkpoint": (
        dict(total_steps=12, ckpt_every=1, max_restarts=2), (5, 9)),
    "failure_before_any_checkpoint_restarts_from_init": (
        dict(total_steps=4, ckpt_every=10), (0,)),
}


@pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
def test_run_with_recovery_as_repro(tmp_path, case):
    kw, fail_at = RECOVERY_CASES[case]
    results = {}
    for pkg, (_, ft, _) in PKGS.items():
        inits = {"n": 0}
        init = _init(pkg)

        def counted():
            inits["n"] += 1
            return init()

        final = ft.run_with_recovery(
            init_state=counted, train_one_step=_counting_step(pkg, fail_at),
            ckpt_dir=str(tmp_path / pkg), **kw)
        results[pkg] = (np.asarray(final["hist"]).tolist(),
                        float(final["x"]), inits["n"])
    n = kw["total_steps"]
    hist, x, inits = results["port"]
    assert results["port"] == results["repro"]
    assert hist[:n] == [1.0] * n and x == float(n)
    assert inits == (2 if 0 in fail_at else 1)


def test_restart_budget_exhaustion_reraises(tmp_path):
    def always_dies(state, step):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError, match="hard failure"):
        tft.run_with_recovery(init_state=_init("port"),
                              train_one_step=always_dies, total_steps=4,
                              ckpt_dir=str(tmp_path), max_restarts=2)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_resume_from_warm_checkpoint_dir(tmp_path, pkg):
    ck, ft, lib = PKGS[pkg]
    ck.save_checkpoint(tmp_path, 5, {"x": lib(np.float32(6.0)),
                                     "hist": lib(np.zeros(32, np.float32))})
    seen = []
    final = ft.run_with_recovery(
        init_state=_init(pkg), train_one_step=_counting_step(pkg),
        total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=2,
        on_step=lambda step, state: seen.append(step))
    assert seen == [6, 7, 8, 9]
    assert float(final["x"]) == 10.0
    assert [s for s, _ in ck.list_checkpoints(tmp_path)][-1] == 9


def test_completed_run_resumes_as_noop(tmp_path):
    kw = dict(init_state=_init("port"), total_steps=6,
              ckpt_dir=str(tmp_path), ckpt_every=2)
    tft.run_with_recovery(train_one_step=_counting_step("port"), **kw)
    steps = []
    final = tft.run_with_recovery(
        train_one_step=_counting_step("port"),
        on_step=lambda step, state: steps.append(step), **kw)
    assert steps == [] and float(final["x"]) == 6.0


def test_invalid_ckpt_every_fails_fast(tmp_path):
    with pytest.raises(ValueError, match="ckpt_every"):
        tft.run_with_recovery(init_state=_init("port"),
                              train_one_step=_counting_step("port"),
                              total_steps=4, ckpt_dir=str(tmp_path),
                              ckpt_every=0)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _heartbeats(mod):
    clk = Clock()
    mon = mod.HeartbeatMonitor(timeout_s=5.0, now=clk)
    out = []
    mon.beat("w0", 1)
    mon.beat("w1", 1)
    clk.t = 5.0  # age == timeout: still alive
    out.append(mon.dead_workers())
    clk.t = 6.0
    out.append(sorted(mon.dead_workers()))
    out.append(mon.dead_workers())  # reported once
    mon.beat("w0", 2)  # revived
    out.append(mon.dead_workers())
    clk.t = 12.0
    out.append(mon.dead_workers())
    mon.beat("fast", 20)
    mon.beat("slow", 10)
    mon.beat("corpse", 2)
    out.append(mon.stragglers(fleet_step=20, max_lag=5))
    out.append(mon.stragglers(fleet_step=15, max_lag=5))
    clk.t = 18.0
    mon.beat("fast", 21)
    mon.beat("slow", 11)
    out.append(mon.dead_workers())
    out.append(mon.stragglers(fleet_step=21, max_lag=5))
    return out


def test_heartbeat_monitor_as_repro():
    got = _heartbeats(tft)
    assert got == _heartbeats(jft)
    assert got[:5] == [[], ["w0", "w1"], [], [], ["w0"]]
    assert got[5:] == [["slow", "corpse"], ["corpse"], ["corpse"], ["slow"]]


POLICY_CASES = {
    "escalates_warn_then_reassign": (3, [2.0, 2.0, 2.0],
                                     ["warn", "warn", "reassign"]),
    "resets_on_meeting_deadline": (2, [2.0, 0.5, 2.0, 2.0],
                                   ["warn", "ok", "warn", "reassign"]),
    "rearms_after_reassign": (2, [2.0, 2.0, 2.0, 2.0],
                              ["warn", "reassign", "warn", "reassign"]),
    "deadline_boundary_is_inclusive": (1, [1.0, 1.0001], ["ok", "reassign"]),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_straggler_policy_as_repro(case):
    patience, seconds, want = POLICY_CASES[case]
    for mod in (tft, jft):
        policy = mod.StragglerPolicy(step_deadline_s=1.0, patience=patience)
        assert [policy.observe(s) for s in seconds] == want
