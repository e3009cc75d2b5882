"""Multi-pod dry-run (port of `repro.launch.dryrun`): run the real step of
every (arch x shape x mesh) cell on a fake world of 256 or 512 ranks.

For each cell this produces, with NOTHING allocated on any device (every
parameter, optimizer moment, batch and cache tensor is a DTensor whose
local shard is a fake tensor of ``torch._subclasses.FakeTensorMode``; on
the card, torch's fake tensors allocate and free one 4-byte tensor once a
process, ``fake_tensor.init_gpu_context``):

  * ``memory``: the per-device bytes of rank 0 (does it fit) —
    ``argument_size_in_bytes``, the local bytes of every input;
    ``output_size_in_bytes``, of every output; ``temp_size_in_bytes``, the
    peak of the local bytes live during the step above the arguments.
    `repro`'s ``generated_code_size_in_bytes`` and ``alias_size_in_bytes``
    (XLA's) have no counterpart and are left out;
  * ``cost``: ``flops``, the FLOPs of rank 0's local ops (the matmul-like
    ops ``torch.utils.flop_counter`` counts), and ``bytes accessed``, the
    input and output bytes of each local aten op summed unfused: an upper
    bound on XLA's fused count. `repro`'s ``optimal_seconds`` is left out;
  * ``collectives``: the bytes of each collective's result on rank 0 by
    kind, under `repro`'s keys (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``; a
    ``broadcast`` and a ``reduce`` (a stacked parameter's row read,
    `sharding.dtensor.stack_row`), which `repro`'s HLO has no names for,
    under their own),
    with ``total_bytes`` and ``op_count``: DTensor's redistributions
    (``_c10d_functional``) and the port's own ``torch.distributed`` calls
    (``c10d``) alike;

and writes one JSON per cell, `repro`'s schema and file name, to
``artifacts/dryrun_torch/``.

The world is a fake process group (``torch.testing``'s ``FakeStore`` and
the ``fake`` backend: rank 0 of 256 or 512, collectives that move
nothing), initialised by `run_cell` and destroyed when the cell ends; the
mesh on it is `launch.mesh`'s own. A cell started in a process that
already holds a process group raises rather than use that group's world.
What the counters see is what rank 0 computes: `StepCounter` lets DTensor
lower each op to its local ops first and counts those, so a replicated
region (the MoE dispatch, the mLSTM heads) counts whole on every rank. A
real tensor that reaches the step is an error.

The same `StepCounter` runs over a real step (`count_step`: plain tensors
on one device, or real DTensors on a gloo grid through
`launch.mesh.run_grid`), which is how the CPU tests and ``chip_smoke.py``
hold the fake counts to real ones.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import time
import weakref
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, applicable_shapes, \
    get_arch
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core.runtime import resolve_device
from repro_torch.models import build_model, cache_shapes, input_specs, \
    param_shapes
from repro_torch.models.transformer import Runtime
from repro_torch.optim.optimizer import OptConfig, OptState, \
    init_opt_state, zero1_opt_state
from repro_torch.optim.tree import named_tensors

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the collective ops the steps issue (``_c10d_functional``: DTensor's
# redistributions; ``c10d``: the port's own ``dist.all_reduce``,
# ``broadcast`` and ``reduce``;
# ``_dtensor``: a shard-to-shard all-to-all) -> `repro`'s HLO name. Any other
# op of these namespaces but the ones that move nothing raises: a collective
# named otherwise (another torch) is never left out of the count.
_KIND_OF = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast_": "broadcast", "reduce_": "reduce",
}
_MOVE_NOTHING = ("wait_tensor", "_wrap_tensor_autograd", "barrier")
_LIFTS = (torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy)
_SYNCS = (torch.ops._c10d_functional.wait_tensor,)
# DTensor's code, and the device mesh's (a sub-mesh or a flattened one
# made on first use, `sharding.dtensor.stack_row`'s group)
_DTENSOR_CODE = ("/torch/distributed/tensor/",
                 "/torch/distributed/device_mesh.py",
                 "/torch/distributed/_mesh_layout.py")
_PORT_CODE = "/repro_torch/"
_THIS_FILE = "/repro_torch/launch/dryrun.py"
_PORT_OPS = "repro_torch"  # the port's own operators (the sLSTM scan)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its attribute: ``to_local`` would record an
    autograd node), a plain tensor as it is."""
    from repro_torch.sharding.dtensor import is_dtensor

    return t._local_tensor if is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(tree) -> list:
    """Every tensor of `tree` (a module's parameters, an `OptState`, nested
    dicts, lists and tuples; other values skipped), in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(named_tensors(tree).values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def local_bytes(tree) -> int:
    """The bytes this rank holds of the tensors of `tree` (a DTensor's
    local shard, a plain tensor whole)."""
    return sum(_nbytes(_local(t)) for t in tensors_of(tree))


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _fakes(tree, fake_mode):
    """`tree` with every real tensor a fake one of `fake_mode`."""
    if torch.is_tensor(tree):
        return tree if _is_fake(tree) else fake_mode.from_tensor(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fakes(v, fake_mode) for v in tree)
    if isinstance(tree, dict):
        return {k: _fakes(v, fake_mode) for k, v in tree.items()}
    return tree


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _from_dtensor() -> bool:
    """Whether the op was issued by DTensor's own code (a helper it builds
    to reckon shard sizes) rather than by the model stack: the nearer of
    the two on the stack decides."""
    import sys

    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if any(code in name for code in _DTENSOR_CODE):
            return True
        if _PORT_CODE in name and not name.endswith(_THIS_FILE):
            return False
        frame = frame.f_back
    return False


class StepCounter:
    """What one rank computes in a step: a ``TorchDispatchMode`` over the
    local ops.

    An op on DTensors is handed back (``NotImplemented``) to DTensor, which
    lowers it to ops on the local shards and the collectives of its
    redistributions; those come back here and are counted: ``flops`` (by
    ``torch.utils.flop_counter``'s formulas), ``bytes_accessed`` (each
    op's input and output bytes, views skipped), each collective's result
    bytes by kind (``collectives``, ``collective_ops``; by kind, result
    shape and dtype in ``collective_sites``), and the live bytes
    of the storages the ops create (``live``, ``peak``; the arguments are
    registered with `track` first). An op that autograd would have
    decomposed (``einsum``, ``matmul``) but that arrives whole, as under
    inference mode, is decomposed here and its parts counted; one of the
    port's own operators (``repro_torch::slstm_scan``) is counted whole, by
    its FLOP formula, and not the ops of its kernel. Ops on
    another fake mode's tensors or on ``meta`` (DTensor's sharding
    propagation) and the index helpers DTensor builds for itself are not
    the rank's work and are not counted.

    With `fake_mode` given (a dry-run; the local shards are its fake
    tensors), no fake mode is active while the step runs, so DTensor runs
    as it does eagerly (an active fake mode reads as tracing to it): the
    step's own factories (``torch.zeros``) and host constants
    (``torch.tensor(0.9)``) are made in `fake_mode` here, and a real tensor
    that reaches an op of the step raises."""

    def __init__(self, fake_mode=None):
        from torch.utils.flop_counter import flop_registry

        self.fake_mode = fake_mode
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, float] = {}
        self.collective_ops = 0
        # (kind, result shapes, dtype) -> (count, bytes): what moved where
        self.collective_sites: Dict[tuple, tuple] = {}
        self.live = 0
        self.peak = 0
        self._storages = {}  # id(storage) -> weakref, for live storages
        self._mode = None
        self._lift_cpu = None
        self._inside = 0

    # -- memory -------------------------------------------------------
    def _free(self, key: int, n: int) -> None:
        self._storages.pop(key, None)
        self.live -= n

    def track(self, tree) -> None:
        """Count the storages of `tree`'s local tensors as live (the step's
        arguments, before it runs)."""
        for t in tensors_of(tree):
            self._register(_local(t))

    def _register(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._storages.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._storages[key] = weakref.ref(st)
        weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    # -- ops ----------------------------------------------------------
    def _mine(self, t: torch.Tensor) -> bool:
        if _is_fake(t):
            return t.fake_mode is self.fake_mode
        return self.fake_mode is None and t.device.type != "meta"

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._schema.name.split("::")[-1]
            kind = _KIND_OF.get(name)
            if kind is None and name not in _MOVE_NOTHING:
                raise NotImplementedError(
                    f"the dry-run does not know the collective {func}: add "
                    f"it to launch.dryrun._KIND_OF")
            if kind is not None:
                written = [a for a, s in zip(args, func._schema.arguments)
                           if s.alias_info is not None
                           and s.alias_info.is_write]
                # ``reduce_`` marks no argument written and returns only
                # its work: its tensors are what it moves
                result = tensors_of(written) or outs or tensors_of(args[0])
                n = float(sum(_nbytes(t) for t in result))
                self.collectives[kind] = self.collectives.get(kind, 0.0) + n
                self.collective_ops += 1
                site = (kind, tuple(tuple(t.shape) for t in result),
                        str(result[0].dtype) if result else "")
                count, total = self.collective_sites.get(site, (0, 0.0))
                self.collective_sites[site] = (count + 1, total + n)
        if not func.is_view and packet not in _SYNCS:
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._register(t)

    def _dispatch(self, func, args, kwargs):
        if self._inside or func.namespace == "prim" or _fake_mode_active():
            # the kernel of an operator counted whole; a tensor's metadata;
            # a fake mode's own handling of an op (its decompositions) or
            # DTensor's shape propagation: counted as the op that got there
            return func(*args, **kwargs)
        if func.namespace == _PORT_OPS:
            self._inside += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self._inside -= 1
        else:
            ins = tensors_of((args, kwargs))
            if self.fake_mode is not None and (not ins or any(
                    not _is_fake(t) and t.device.type != "meta"
                    for t in ins)):
                return self._not_all_fake(func, args, kwargs, ins)
            out = func(*args, **kwargs)
            if not all(self._mine(t) for t in ins + tensors_of(out)):
                return out
        self._count(func, args, kwargs, out)
        return out

    def _not_all_fake(self, func, args, kwargs, ins):
        """An op of a dry-run with no input or a real one: a factory, a
        host constant (``torch.tensor`` lifts it), or an op on real
        tensors. DTensor's own helpers stay real (and meet the fake shards
        as fakes); the step's factories and constants are made fake; a
        real tensor of the step raises."""
        fake = self.fake_mode
        if not ins and str(kwargs.get("device")) == "meta":
            return func(*args, **kwargs)  # a shape's stand-in
        real = [t for t in ins if not _is_fake(t)]
        if _from_dtensor():
            if len(real) == len(ins):
                return func(*args, **kwargs)
        elif func._overloadpacket in _LIFTS:
            return fake.from_tensor(args[0])
        elif real:
            t = real[0]
            raise RuntimeError(
                f"a real tensor {tuple(t.shape)} {t.dtype} on {t.device} "
                f"reached the dry-run's step ({func})")
        args, kwargs = _fakes((args, kwargs), fake)
        with fake:
            out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented  # DTensor lowers it to local ops
                if func.namespace == "aten" and \
                        torch._C._dispatch_has_kernel_for_dispatch_key(
                            func.name(), "CompositeImplicitAutograd"):
                    with self:
                        out = func.decompose(*args, **kwargs)
                    if out is not NotImplemented:
                        return out
                return counter._dispatch(func, args, kwargs)

        if self.fake_mode is not None:
            # torch.tensor(x, device=...) builds on the host and lifts (as
            # under an active fake mode), never on the device
            self._lift_cpu = torch._C._only_lift_cpu_tensors()
            torch._C._set_only_lift_cpu_tensors(True)
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        if self._lift_cpu is not None:
            torch._C._set_only_lift_cpu_tensors(self._lift_cpu)
            self._lift_cpu = None

    def collective_summary(self) -> Dict[str, Any]:
        """`repro`'s ``collectives`` dict: bytes by kind, ``total_bytes``,
        ``op_count``."""
        out: Dict[str, Any] = dict(self.collectives)
        out["total_bytes"] = float(sum(self.collectives.values()))
        out["op_count"] = self.collective_ops
        return out


# ---------------------------------------------------------------------------
# The world and the step's inputs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of `world` ranks, this process rank 0,
    for the duration of the context. Raises if a process group already
    exists (its world would be used instead, quietly)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "a dry-run initialises a fake process group of its own, but "
            f"this process already holds one ({dist.get_backend()}, world "
            f"{dist.get_world_size()}): run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(int(s)) for s in shape)


def mesh_of(shape: Sequence[int], device):
    from repro_torch.launch.mesh import make_process_mesh, \
        make_production_mesh

    shape = tuple(shape)
    if shape == (16, 16):
        return make_production_mesh(device=device)
    if shape == (2, 16, 16):
        return make_production_mesh(multi_pod=True, device=device)
    if len(shape) != 2:
        raise ValueError(f"a mesh is (data, model) or the production "
                         f"(2, 16, 16), got {shape}")
    return make_process_mesh(*shape, device=device)


def _fill_cache_stubs(cfg: ArchConfig, cache, cell: ShapeCell):
    """``init_cache`` leaves enc_out/image_embeds as None (set by the
    serving layer); give them their shapes (on ``meta``) for the step."""
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        cache["enc_out"] = torch.empty(
            (cell.global_batch, cell.seq_len, cfg.d_model), dtype=dt,
            device="meta")
    if cfg.family == "vlm":
        cache["image_embeds"] = torch.empty(
            (cell.global_batch, cfg.cross_attn.n_image_tokens, cfg.d_model),
            dtype=dt, device="meta")
    return cache


def _place_tree(tree, make, shardings, prefix=""):
    """`tree` (nested dicts, lists and tuples) with each tensor ``make(t, sharding
    of its dotted name)`` (``None`` without `shardings`); other values as
    they are."""
    if torch.is_tensor(tree):
        return make(tree, shardings[prefix] if shardings else None)
    if isinstance(tree, dict):
        return {k: _place_tree(v, make, shardings,
                               f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, make, shardings,
                                      f"{prefix}.{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return tree


def step_inputs(cfg: ArchConfig, cell: ShapeCell, rt: Runtime, *, mesh=None,
                device=None, fake_mode=None, zero1: bool = False,
                fsdp: bool = False, expert_2d: bool = False, make=None):
    """(step, arguments) of `cell`: the step function of its kind and its
    arguments, every tensor placed on `mesh` by `repro`'s rules
    (`sharding.rules`, which see the shapes on ``meta``) with uninitialised
    local shards (``dtensor.empty``; made in `fake_mode` when one is given:
    fake tensors), or, with no mesh, plain tensors of zeros on `device`.
    Nothing is drawn: values do not change what a step computes, moves and
    holds. ``make(t, sharding, dtype)``, when given, makes each tensor
    instead (``t`` on ``meta``; ``sharding`` None without a mesh)."""
    from repro_torch.sharding import dtensor
    from repro_torch.sharding.rules import batch_pspecs, cache_pspecs, \
        cache_stacked, param_pspecs, tensor_pspecs, \
        to_shardings, zero1_stacked_pspecs, zero1_tensor_pspecs
    from repro_torch.train.steps import make_prefill_step, \
        make_serve_step, make_train_step

    model = build_model(cfg)
    params = _param_shapes(cfg)  # on meta
    if fsdp and mesh is not None:
        # FSDP holds a leaf that no per-layer placement holds in `repro`'s
        # bytes stacked, as `repro` does (ROADMAP C27): one tensor on its
        # fold, each layer reading its row (`dtensor.stack_row`)
        params = _stacked_param_shapes(cfg, tuple(sorted(
            zero1_stacked_pspecs(params, mesh, expert_2d=expert_2d))))
    tree = params.to_tree()
    train = cell.kind == "train"

    def shardings(specs, of, stacked=None):
        if mesh is None:
            return None
        return to_shardings(tensor_pspecs(of, specs, stacked), mesh)

    def batch_shardings(specs):
        return None if mesh is None else to_shardings(
            batch_pspecs(specs, mesh), mesh)

    if mesh is None:
        p_sh = m_sh = None
    else:
        # FSDP parameters: `repro`'s fold, per layer (a stacked leaf's on
        # its layer axis)
        unfolded = shardings(param_pspecs(params, mesh, expert_2d=expert_2d),
                             params)
        p_sh = to_shardings(zero1_tensor_pspecs(
            params, mesh, expert_2d=expert_2d), mesh) if fsdp else unfolded
        # the moments on `repro`'s: ZeRO-1's (`zero1_opt_state`) under
        # zero1, else the rules'
        m_sh = unfolded if train and (zero1 or fsdp) else None
    if cell.kind == "decode":
        batch = {"tokens": torch.empty((cell.global_batch, 1),
                                       dtype=torch.int32, device="meta")}
        cache = _fill_cache_stubs(cfg, cache_shapes(
            cfg, cell.global_batch, cell.seq_len, rt), cell)
        c_sh = None if mesh is None else shardings(
            cache_pspecs(cfg, cache, mesh), cache,
            cache_stacked(cfg, cache))
    else:
        batch = input_specs(cfg, cell.global_batch, cell.seq_len)
    b_sh = batch_shardings(batch)

    def placed_empty(t, sharding, dtype=None):
        if sharding is None:
            return torch.zeros(t.shape, dtype=dtype or t.dtype,
                               device=device)
        if dtype is not None:
            t = torch.empty(t.shape, dtype=dtype, device="meta")
        out = dtensor.empty(t, sharding, device)
        if fake_mode is None:
            out.to_local().zero_()
        return out

    make = make or placed_empty

    with fake_mode if fake_mode is not None else contextlib.nullcontext():
        placed = params.like(_place_tree(tree, make, p_sh))
        batch = _place_tree(batch, make, b_sh)
        if train:
            step_device = device if device is not None or mesh is None \
                else dtensor.mesh_device(mesh)
            if m_sh is None:
                opt = init_opt_state(placed)
            elif zero1:  # the moments a leaf stacked where no per-layer
                # placement holds `repro`'s bytes (ROADMAP C27)
                opt = zero1_opt_state(
                    params, mesh, expert_2d=expert_2d,
                    make=lambda t, sh: make(t, sh, torch.float32),
                    device=step_device)
            else:
                def moment():
                    return params.like(_place_tree(
                        tree, lambda t, sh: make(t, sh, torch.float32),
                        m_sh)).requires_grad_(False)

                opt = OptState(mu=moment(), nu=moment(), step=torch.zeros(
                    (), dtype=torch.int32, device=step_device))
            return make_train_step(model, OptConfig(), rt), \
                (placed, opt, batch)
        if cell.kind == "prefill":
            return make_prefill_step(model, rt), (placed, batch)
        placed_cache = _place_tree(cache, make, c_sh)
        return make_serve_step(model, rt), \
            (placed, batch["tokens"], placed_cache)


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg: ArchConfig):
    """`models.param_shapes`, once an arch (`step_inputs` only reads it)."""
    return param_shapes(cfg)


@functools.lru_cache(maxsize=None)
def _stacked_param_shapes(cfg: ArchConfig, keys: tuple):
    """`_param_shapes` with the leaves `keys` held stacked
    (`optim.tree.stack_leaves`), once an arch and set of leaves."""
    from repro_torch.optim.tree import stack_leaves

    params = _param_shapes(cfg)
    return stack_leaves(params, keys) if keys else params


def default_runtime(cell: ShapeCell) -> Runtime:
    """`repro`'s dry-run runtime: remat ``dots`` for training, ``none``
    otherwise."""
    return Runtime(remat="dots" if cell.kind == "train" else "none",
                   scan_layers=True)


def count_step(step, args, counter: StepCounter) -> Dict[str, Any]:
    """Run ``step(*args)`` under `counter` (the arguments tracked as live
    first) and return `repro`'s ``memory``, ``cost`` and ``collectives``
    dicts of what this rank did."""
    counter.track(args)
    arg_bytes = local_bytes(args)
    with counter:
        out = step(*args)
    memory = {
        "argument_size_in_bytes": float(arg_bytes),
        "output_size_in_bytes": float(local_bytes(out)),
        "temp_size_in_bytes": float(max(counter.peak - arg_bytes, 0)),
    }
    cost = {"flops": float(counter.flops),
            "bytes accessed": float(counter.bytes_accessed)}
    return {"memory": memory, "cost": cost,
            "collectives": counter.collective_summary()}


def grid_counts(case: Dict[str, Any]) -> Dict[str, Any]:
    """One rank of a real grid (`launch.mesh.run_grid`): `count_step` of
    the step of ``case`` (``arch``, ``reduced``, ``cell``: `ShapeCell`'s
    fields, ``mesh``: its shape) on real DTensors of zeros on this rank's
    process mesh, under the counter the dry-run uses."""
    from repro_torch.sharding.dtensor import mesh_device

    cfg = get_arch(case["arch"])
    if case.get("reduced"):
        cfg = cfg.reduced()
    cell = ShapeCell(*case["cell"])
    mesh = mesh_of(case["mesh"], case.get("device", "cpu"))
    step, args = step_inputs(cfg, cell, default_runtime(cell), mesh=mesh,
                             device=mesh_device(mesh))
    return count_step(step, args, StepCounter())


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: Optional[str]
    seconds: float
    memory: Dict[str, float]
    cost: Dict[str, float]
    collectives: Dict[str, Any]
    runtime: Dict[str, Any]


def run_cell(
    cfg: ArchConfig,
    cell: ShapeCell,
    *,
    multi_pod: bool = False,
    rt: Optional[Runtime] = None,
    save: bool = True,
    tag: str = "baseline",
    zero1: bool = False,
    fsdp: bool = False,
    expert_2d: bool = False,
    device=None,
    mesh_shape: Optional[Sequence[int]] = None,
) -> CellResult:
    """The dry-run of one cell on rank 0 of a fake world: the production
    mesh (16x16, or 2x16x16 with `multi_pod`) unless `mesh_shape` names
    another (data, model) grid. `device` is the fake tensors' (default the
    card; nothing is allocated on it). A cell that fails (a step that does
    not run, a layout with no per-layer form) reports ``ok=False`` and its
    error; only a process group that already exists raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    device = resolve_device(device)
    shape = tuple(mesh_shape) if mesh_shape is not None else (
        (2, 16, 16) if multi_pod else (16, 16))
    rt = rt or default_runtime(cell)
    err = None
    counts: Dict[str, Any] = {"memory": {}, "cost": {}, "collectives": {}}
    world = 1
    for s in shape:
        world *= int(s)
    with fake_world(world):
        try:
            mesh = mesh_of(shape, device)
            fake_mode = FakeTensorMode(allow_non_fake_inputs=False)
            step, args = step_inputs(
                cfg, cell, rt, mesh=mesh, device=device,
                fake_mode=fake_mode, zero1=zero1, fsdp=fsdp,
                expert_2d=expert_2d)
            counts = count_step(step, args, StepCounter(fake_mode))
            ok = True
        except Exception as e:  # noqa: BLE001 — any failure is a dry-run bug
            ok = False
            err = f"{type(e).__name__}: {e}"[:2000]
    res = CellResult(
        arch=cfg.name,
        shape=cell.name,
        mesh=mesh_name(shape),
        ok=ok,
        error=err,
        seconds=round(time.time() - t0, 1),
        memory=counts["memory"],
        cost=counts["cost"],
        collectives=counts["collectives"],
        runtime={"remat": rt.remat, "scan_layers": rt.scan_layers,
                 "embed_backend": rt.embed_backend, "tag": tag,
                 "zero1": zero1, "fsdp": fsdp, "expert_2d": expert_2d,
                 "moe_dp_shards": rt.moe_dp_shards,
                 "moe_ep_constraint": rt.moe_ep_constraint,
                 "seq_shard_attention": rt.seq_shard_attention},
    )
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        out = ARTIFACTS / f"{cfg.name}__{cell.name}__{res.mesh}__{tag}.json"
        out.write_text(json.dumps(dataclasses.asdict(res), indent=2))
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", type=str, default="baseline")
    ap.add_argument(
        "--unrolled", action="store_true",
        help="accepted for repro's command line: the port has no layer "
        "scan (every layer runs and is counted), so the counts are the "
        "same as without it")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="the fake tensors' device (nothing is allocated)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cells = []
    if args.all:
        for cfg in ARCHS.values():
            for cell in applicable_shapes(cfg):
                cells.append((cfg, cell))
    else:
        cfg = get_arch(args.arch)
        cells.append((cfg, SHAPES_BY_NAME[args.shape]))

    n_fail = 0
    for cfg, cell in cells:
        rt = None
        if args.unrolled:
            rt = Runtime(remat="dots" if cell.kind == "train" else "none",
                         scan_layers=False)
        res = run_cell(cfg, cell, multi_pod=args.multi_pod, tag=args.tag,
                       rt=rt, device=device)
        status = "OK " if res.ok else "FAIL"
        flops = res.cost.get("flops", 0)
        cb = res.collectives.get("total_bytes", 0)
        print(
            f"[{status}] {cfg.name:28s} {cell.name:12s} {res.mesh:8s} "
            f"{res.seconds:7.1f}s flops={flops:.3e} coll={cb:.3e} "
            f"{res.error or ''}",
            flush=True,
        )
        n_fail += 0 if res.ok else 1
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
