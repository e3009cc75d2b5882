"""Trees on a process mesh as DTensors (``torch.distributed.tensor``): the
port's counterpart of `jax.device_put` onto ``NamedSharding``s.

  * `distribute(t, sharding)`: a full tensor, the same on every rank (a
    seeded init, a restored checkpoint, a batch built from the seed), as a
    DTensor whose local shard each rank cuts from its own copy: no
    collective, as every rank already holds the values.
  * `distribute_module(module, shardings)`: every parameter named in
    `shardings` replaced, in place, by its DTensor (or by an uninitialized
    one, for a restore to fill).
  * `place_tree(tree, mesh)`: a layer's tensors placed by the rules of
    their names, as the layer is drawn.
  * `redistribute(t, placements)`: ``t.redistribute``, but a change of
    placement on mesh dims of one rank only relabels the local tensor (so
    a 1x1 mesh keeps the single-card step's memory layouts, and its bits).
  * `full(t)`: the whole tensor of a DTensor. This is a collective: every
    rank of the mesh must call it, in the same order (a rank-0-only call,
    for a log line or a write, hangs the grid).
  * `vocab_lookup(table, ids)`: the embedding lookup in a vocab-sharded
    table.
  * `einsum(eq, *ops)`: an einsum of DTensor operands contracted shard by
    shard on the letters the output keeps.
  * `replicated(fn, *args)`: ``fn`` on the replicated local values of
    DTensor arguments, its results replicated DTensors (the MoE dispatch).
  * `register_rules()`: the sharding rules the model stack needs that
    DTensor lacks (``log_sigmoid_backward``, ``flip``).
  * `keep_only(t, dims)`: only `dims` left sharded, before a reshape that
    merges a sharded dim into the one before it.
  * `replication(tree)`: a context in which plain tensors (positions,
    masks, the learning rate) meet DTensors as replicated values, when
    `tree` holds DTensors.

``torch.distributed.tensor`` is imported inside each function, never when
this module is imported.
"""
from __future__ import annotations

import contextlib
import string
from typing import Callable, Dict

import torch
from torch import nn

from .rules import Sharding


_DTENSOR = []  # the DTensor class, once imported


def _dtensor_cls():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor. A plain tensor or parameter answers from
    its type alone (the single-card paths ask on every op), without
    importing ``torch.distributed.tensor``."""
    if type(t) in (torch.Tensor, nn.Parameter):
        return False
    return isinstance(t, torch.Tensor) and isinstance(t, _dtensor_cls())


def wrap(local: torch.Tensor, mesh, placements, shape=None):
    """``DTensor.from_local`` of this rank's `local` (unchecked: every rank
    built its piece from the same values). With the global `shape` given,
    shards may be uneven and the global layout is contiguous; without it,
    the global shape and strides follow from `local`'s."""
    if shape is None:
        return _dtensor_cls().from_local(local, mesh, placements,
                                         run_check=False)
    shape = torch.Size(shape)
    return _dtensor_cls().from_local(
        local, mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def replicated_value(t: torch.Tensor, mesh):
    """A plain tensor, the same on every rank, as a replicated DTensor."""
    from torch.distributed.tensor import Replicate

    return wrap(t, mesh, [Replicate()] * mesh.ndim)


def local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of the full tensor `t` under `placements` (each
    ``Shard`` mesh dim splits as ``torch.chunk`` does, in mesh-dim order,
    as DTensor lays shards out)."""
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            t = torch.chunk(t, mesh.size(i), dim=pl.dim)[
                mesh.get_local_rank(i)]
    return t


def mesh_device(mesh) -> torch.device:
    """This rank's device on a process mesh: the card it set as current
    (`launch.mesh.make_process_mesh` does), or the CPU of a CPU mesh."""
    from repro_torch.core.runtime import resolve_device

    return resolve_device("cpu" if mesh.device_type == "cpu" else None)


def distribute(t: torch.Tensor, sharding: Sharding, device=None):
    """`t` (the full tensor, the same on every rank) as a DTensor on
    ``sharding``; the local shard is cut here and copied to `device` when
    one is given. A shard smaller than `t` gets storage of its own, so
    dropping `t` frees it."""
    register_rules()
    local = local_chunk(t, sharding.mesh, sharding.placements)
    if local.numel() < t.numel():
        local = local.clone()
    if device is not None:
        local = local.to(device)
    return wrap(local.contiguous(), sharding.mesh, sharding.placements,
                shape=t.shape)


def empty(t: torch.Tensor, sharding: Sharding, device=None):
    """An uninitialized DTensor of `t`'s shape and dtype on ``sharding``:
    only this rank's shard is allocated, on `device` (default the mesh's).
    `t` may lie on ``meta``."""
    register_rules()
    mesh, placements = sharding.mesh, sharding.placements
    shape = local_chunk(torch.empty(t.shape, device="meta"), mesh,
                        placements).shape
    local = torch.empty(shape, dtype=t.dtype,
                        device=device or mesh_device(mesh))
    return wrap(local, mesh, placements, shape=t.shape)


def distribute_module(module: nn.Module, shardings: Dict[str, Sharding], *,
                      device=None, values: bool = True) -> nn.Module:
    """Replace every parameter of `module` that `shardings` names (by its
    dotted name) with its DTensor, in place; a parameter already a DTensor
    is left as it is. The shards are cut from the parameters' values and
    copied to `device` when one is given; with ``values=False`` they are
    allocated uninitialized on the mesh's device instead (`empty`: the
    parameters may lie on ``meta``), for a restore to fill. Returns
    `module`."""
    for prefix, mod in module.named_modules():
        for pname, p in list(mod._parameters.items()):
            name = f"{prefix}.{pname}" if prefix else pname
            if p is None or name not in shardings or is_dtensor(p):
                continue
            place = distribute if values else empty
            mod._parameters[pname] = nn.Parameter(
                place(p.detach(), shardings[name], device),
                requires_grad=p.requires_grad)
    return module


def place_tree(tree, mesh):
    """A parameter tree (nested dicts and lists of tensors, a layer's or a
    whole model's) with every tensor not yet a DTensor placed on `mesh` by
    the rule of its last key (`rules.leaf_spec`, which gives it what
    `rules.param_pspecs` gives it in the whole model). A family's ``init``
    calls it on each layer as soon as the layer is drawn (``place``), so
    that a model is never whole on one rank."""
    from .rules import leaf_spec, to_placements

    def walk(value, name):
        if torch.is_tensor(value):
            if is_dtensor(value):
                return value
            spec = leaf_spec(name, tuple(value.shape), mesh)
            return distribute(value, Sharding(mesh, to_placements(spec,
                                                                  mesh)))
        if isinstance(value, dict):
            return {k: walk(v, k) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(walk(v, str(i)) for i, v in enumerate(value))
        return value  # None

    return walk(tree, "")


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (collective), a plain tensor as it
    is."""
    return t.full_tensor() if is_dtensor(t) else t


def redistribute(t, placements):
    """``t.redistribute`` onto `placements` of its mesh; where the
    placements differ only on mesh dims of one rank (a ``Partial`` or a
    ``Shard`` of one piece is the whole tensor there) the local tensor is
    relabelled as it is, keeping its memory layout and moving nothing."""
    mesh = t.device_mesh
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    if all(mesh.size(i) == 1 for i, (a, b) in
           enumerate(zip(t.placements, placements)) if a != b):
        return _dtensor_cls().from_local(
            t.to_local(), mesh, placements, run_check=False, shape=t.shape,
            stride=t.stride())
    return t.redistribute(mesh, placements)


class _GradOnPlacements(torch.autograd.Function):
    """The identity forward on a DTensor; backward, the gradient
    redistributed to the forward's placements (DTensor passes a view's
    gradient on in whatever layout it arrives)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, ctx.placements)


def keep_only(t: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor redistributed so that only its `dims` stay sharded (every
    other mesh dim ``Replicate()``), and its gradient too: around a reshape
    that merges a sharded dim into the one before it, which torch 2.11
    refuses (2.13 would write a ``_StridedShard``). A plain tensor as it
    is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % t.ndim for d in dims}
    return _GradOnPlacements.apply(redistribute(
        t, [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in t.placements]))


def replicate(t: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to ``Replicate()`` on every mesh dim (a
    pending ``Partial`` reduced, shards gathered); a plain tensor as it
    is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    return redistribute(t, [Replicate()] * t.device_mesh.ndim)


class _VocabShardLookup(torch.autograd.Function):
    """``table[ids]`` on this rank's rows ``[lo, lo + len(table))`` of a
    vocab-sharded table: ids outside them read zeros and the rows are
    summed over `groups` (the vocab shards; each row comes from one shard,
    the others add zeros). Backward: the table's gradient scatter-added
    over the rank's own ids (``index_put_`` with ``accumulate``, as the
    gradient of ``table[ids]``). With no group to sum over it is
    ``table[ids]`` and its gradient exactly."""

    @staticmethod
    def forward(ctx, table, ids, lo, groups):
        import torch.distributed as dist

        inside = (ids >= lo) & (ids < lo + table.shape[0])
        local = torch.where(inside, ids - lo, torch.zeros_like(ids))
        rows = table[local]
        if groups:
            rows = torch.where(inside[..., None], rows,
                               torch.zeros_like(rows))
            for group in groups:
                dist.all_reduce(rows, group=group)
        ctx.save_for_backward(local, inside)
        ctx.table_shape, ctx.masked = table.shape, bool(groups)
        return rows

    @staticmethod
    def backward(ctx, grad):
        local, inside = ctx.saved_tensors
        if ctx.masked:
            grad = torch.where(inside[..., None], grad,
                               torch.zeros_like(grad))
        table_grad = grad.new_zeros(ctx.table_shape).index_put_(
            (local,), grad, accumulate=True)
        return table_grad, None, None, None


def vocab_lookup(table, ids):
    """``table[ids]`` of a DTensor table whose rows (the vocabulary) are
    sharded over some mesh dims: each rank looks up the ids in its own
    rows and the partial rows are summed over those mesh dims (an
    all-reduce of the (..., D) output; `repro`'s C5 site). The ids keep
    their sharding elsewhere (the batch over 'data'), and so does the
    output; the table's gradient is a partial sum over those dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = replicated_value(ids, mesh)
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    want_t = [Shard(0) if v else Replicate() for v in vocab]
    want_i = [Replicate() if v or not isinstance(p, Shard) else p
              for v, p in zip(vocab, ids.placements)]
    table = redistribute(table, want_t)
    ids = redistribute(ids, want_i)
    lo, n = 0, table.shape[0]
    for i, v in enumerate(vocab):
        if v:  # torch.chunk's split, in mesh-dim order
            chunk = -(-n // mesh.size(i))
            lo += chunk * mesh.get_local_rank(i)
            n = max(0, min(chunk, n - chunk * mesh.get_local_rank(i)))
    groups = [mesh.get_group(i) for i, v in enumerate(vocab)
              if v and mesh.size(i) > 1]
    local_table = _local(table, [Partial() if isinstance(pi, Shard) else pt
                                 for pt, pi in zip(want_t, want_i)])
    rows = _VocabShardLookup.apply(local_table, ids.to_local(), lo, groups)
    return wrap(rows, mesh, want_i,
                shape=tuple(ids.shape) + (table.shape[1],))


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` redistributed to `ref`'s placements when both are DTensors: a
    gradient's pending data-axis ``Partial(sum)`` becomes the reduced
    gradient on its parameter's layout."""
    if is_dtensor(t) and is_dtensor(ref):
        return redistribute(t, ref.placements)
    return t


def replicated(fn: Callable, *args):
    """``fn(*locals)`` on the replicated values of the DTensor arguments,
    each tensor it returns a replicated DTensor on their mesh: a region
    every rank computes whole, for ops of the model stack whose output
    shape depends on the data (``bincount``) or that DTensor cannot shard
    on every torch (the MoE dispatch's scatter and gather). Differentiable:
    a sharded argument is gathered, and its gradient cut back to its shard.
    Without DTensor arguments it is ``fn(*args)``."""
    meshes = [a.device_mesh for a in args if is_dtensor(a)]
    if not meshes:
        return fn(*args)
    mesh = meshes[0]
    out = fn(*(_local(replicate(a)) if is_dtensor(a) else a for a in args))

    def back(t):
        return replicated_value(t, mesh) if torch.is_tensor(t) else t

    return tuple(back(t) for t in out) if isinstance(out, tuple) \
        else back(out)


def _dense(t: torch.Tensor) -> bool:
    """Whether `t`'s elements fill its memory once each (a permutation of a
    contiguous layout; size-1 dims take any stride)."""
    expected = 1
    for d in sorted(range(t.dim()), key=t.stride):
        if t.shape[d] == 1:
            continue
        if t.stride(d) != expected:
            return False
        expected *= t.shape[d]
    return True


class _GradAsInput(torch.autograd.Function):
    """The identity forward; backward, the gradient laid out as the input
    was (`to_local`'s backward wraps the local gradient in a DTensor with
    the input's strides, so a gradient laid out otherwise would be read
    wrong by the next view). A dense input's layout is copied exactly;
    any other (an expanded view) gets a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.stride = x.stride() if _dense(x) else None
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.stride is None:
            return grad.contiguous()
        if grad.stride() == ctx.stride:
            return grad
        return torch.empty_strided(grad.shape, ctx.stride, dtype=grad.dtype,
                                   device=grad.device).copy_(grad)


def _local(t: torch.Tensor, grad_placements=None) -> torch.Tensor:
    """``t.to_local(grad_placements)`` with its gradient laid out as `t`'s
    local tensor."""
    return _GradAsInput.apply(t.to_local(grad_placements=grad_placements))


def _einsum_terms(eq: str, ops) -> tuple:
    """(input terms, output term) of `eq` with every ``...`` spelled out in
    letters the equation does not use (aligned from the right, as
    broadcasting aligns them)."""
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    ell = max((op.ndim - len(t) + 3 for t, op in zip(terms, ops)
               if "..." in t), default=0)
    spare = "".join(c for c in string.ascii_letters if c not in eq)[:ell]
    terms = [t.replace("...", spare[ell - (op.ndim - len(t) + 3):])
             for t, op in zip(terms, ops)]
    return terms, out.replace("...", spare)


def einsum(eq: str, *ops):
    """``torch.einsum`` of DTensor operands, computed shard by shard.

    DTensor runs an einsum through its decomposition (permutes, views,
    ``bmm``), and some torch versions refuse to flatten a sharded dim that
    is not the leading one of the group (the attention scores' batch and
    head dims). Here each mesh dim keeps the sharding of one letter that
    the output keeps (a batch letter like the attention's heads, or an
    operand's own free letter like the vocab of the logits): every operand
    holding that letter is redistributed to be sharded on it, every other
    operand to ``Replicate()`` on that mesh dim, and a mesh dim sharding
    only contracted letters is replicated. Each rank then contracts its
    local shards with ``torch.einsum`` and the result is sharded on the
    kept letters, laid out as ``torch.einsum`` made it. Differentiable
    (``to_local``/``from_local``; the gradient of an operand replicated
    against a sharded output is a ``Partial(sum)``); plain operands are
    replicated values."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = next(o.device_mesh for o in ops if is_dtensor(o))
    ops = [o if is_dtensor(o) else replicated_value(o, mesh) for o in ops]
    terms, out = _einsum_terms(eq, ops)
    sizes = {}
    for term, op in zip(terms, ops):
        for c, n in zip(term, op.shape):
            sizes.setdefault(c, set()).add(int(n))
    keep = []
    for i in range(mesh.ndim):
        letter = None
        for term, op in zip(terms, ops):
            pl = op.placements[i]
            if isinstance(pl, Shard):
                c = term[pl.dim]
                if c in out and len(sizes[c]) == 1 and c not in keep:
                    letter = c
                    break
        keep.append(letter)
    locals_ = []
    for term, op in zip(terms, ops):
        want = [Shard(term.index(c)) if c is not None and c in term
                else Replicate() for c in keep]
        op = redistribute(op, want)
        # an operand without a kept letter meets one shard of the output on
        # each rank: its local gradient is a partial sum over that mesh dim
        locals_.append(_local(op, [
            Partial() if c is not None and c not in term else pl
            for c, pl in zip(keep, want)]))
    res = torch.einsum(",".join(terms) + "->" + out, *locals_)
    placements = [Shard(out.index(c)) if c is not None else Replicate()
                  for c in keep]
    if all(c is None or max(sizes[c]) % mesh.size(i) == 0
           for i, c in enumerate(keep)):
        # even shards: the global shape and strides follow from the local
        # result, whose layout stays as torch.einsum made it
        return wrap(res, mesh, placements)
    return wrap(res.contiguous(), mesh, placements,
                shape=[max(sizes[c]) for c in out])


_REGISTERED = []


def register_rules() -> None:
    """Register the sharding rules DTensor lacks for ops of the model stack
    (once per process): ``aten.log_sigmoid_backward`` (the xLSTM gates'
    ``logsigmoid``) as the pointwise op it is, its operands replicated or
    all sharded on one dim; ``aten.flip`` (``cumsum``'s backward, torch
    2.11 has no rule) sharded on any dim it does not flip."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_out, x, buffer):
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(x.ndim):
            out.append(([Shard(d)], [Shard(d), Shard(d), Shard(d)]))
        return out

    @register_sharding(aten.flip.default)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
            if d not in flipped]

    _REGISTERED.append(True)


def holds_dtensors(tree) -> bool:
    from repro_torch.optim.tree import named_tensors

    return any(is_dtensor(t) for t in named_tensors(tree).values())


def replication(tree):
    """``implicit_replication()`` when `tree` (a tensor, a module or nested
    dicts of tensors) holds DTensors, else a context that does nothing."""
    if not (is_dtensor(tree) if torch.is_tensor(tree)
            else holds_dtensors(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
