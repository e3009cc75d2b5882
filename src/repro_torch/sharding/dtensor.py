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
    table; `vocab_nll(logits, targets)`: the next-token loss of
    vocab-sharded logits.
  * `einsum(eq, *ops)`: an einsum of DTensor operands contracted shard by
    shard on the letters the output keeps.
  * `replicated(fn, *args)`: ``fn`` on the replicated local values of
    DTensor arguments, its results replicated DTensors (the MoE dispatch).
  * `batch_local(fn, *args, batched)`: ``fn`` on this rank's rows of the
    batch, its results sharded as the batch (the sLSTM recurrence).
  * `register_rules()`: the sharding rules the model stack needs that
    DTensor lacks (``log_sigmoid_backward``, ``flip``).
  * `keep_only(t, dims)`: only `dims` left sharded, before a reshape that
    merges a sharded dim into the one before it.
  * `shard_on(t, dim, axis)`: `dim` sharded over a named mesh axis (the
    sequence-sharded attention).
  * `fit_split(t, dim, parts)`: `dim` left sharded only where its shards
    hold whole parts, before a reshape that splits it (into heads);
    `fit_merged` the same for the gradient of a merge.
  * `index_copy_(cache, dim, rows, new)`: a decode cache's write at its
    index, each rank into its own shard (`local_offset`: where it starts).
  * `replication(tree)`: a context in which plain tensors (positions,
    masks, the learning rate) meet DTensors as replicated values, when
    `tree` holds DTensors.
  * `stack_row(stack, index)`: a layer's row of a stacked parameter
    (`optim.tree.stack_leaves`), broadcast by the rank that holds it,
    never the stack gathered (FSDP's fold onto a layer axis, C27).

``torch.distributed.tensor`` is imported inside each function, never when
this module is imported.
"""
from __future__ import annotations

import contextlib
import string
from typing import Callable, Dict

import numpy as np
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


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of this rank's shard of a tensor of `shape` under
    `placements`: `local_chunk`'s, reckoned without a tensor (each
    ``Shard`` mesh dim splits its dim in chunks of ``ceil(n / k)``, as
    ``torch.chunk`` does)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, k = out[pl.dim], mesh.size(i)
            chunk = -(-n // k)
            out[pl.dim] = max(0, min(chunk, n - chunk * mesh.get_local_rank(i)))
    return tuple(out)


def local_offset(shape, mesh, placements, dim: int) -> int:
    """This rank's first index along `dim` of a tensor of `shape` under
    `placements`: where `local_shape`'s shard starts (each ``Shard`` mesh
    dim of `dim`, in mesh order, cuts what the ones before it left)."""
    n, first = shape[dim], 0
    for i, pl in enumerate(placements):
        if pl.is_shard() and pl.dim % len(shape) == dim % len(shape):
            chunk = -(-n // mesh.size(i))
            start = min(chunk * mesh.get_local_rank(i), n)
            first += start
            n = max(0, min(chunk, n - start))
    return first


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
    local = torch.empty(local_shape(t.shape, mesh, placements),
                        dtype=t.dtype, device=device or mesh_device(mesh))
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


def shard_on(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """A DTensor redistributed so that its dim `dim` is sharded over the
    mesh dim named `axis`, every other mesh dim's placement kept; its
    gradient comes back on `t`'s placements. A layout lever
    (`Runtime.seq_shard_attention`): on a mesh without `axis` it raises,
    never leaving the layout as it was. A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard

    names = list(t.device_mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"cannot shard dim {dim} over {axis!r}: the mesh's "
                         f"axes are {names}")
    want = list(t.placements)
    want[names.index(axis)] = Shard(dim % t.ndim)
    return redistribute(t, want)


def shards_inner_dims(t) -> bool:
    """Whether the DTensor `t` is split on a dim other than its first and
    its last (one that a matmul's flatten would merge into the dim before
    it) over a mesh dim of more than one rank."""
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and 0 < p.dim % t.ndim < t.ndim - 1
               and t.device_mesh.size(i) > 1
               for i, p in enumerate(t.placements))


def fit_split(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """A DTensor about to have its dim `dim` split into (`parts`, ...):
    the mesh dims sharding it are kept, major first, while their shards
    hold whole parts, and the rest replicated first (4 kv heads on a model
    axis of 16; tokens sharded over data and model, split back into a batch
    of 32), its gradient coming back sharded as before. DTensor refuses (or
    on some versions miscounts) a view that would leave a shard holding
    part of a head or of a sequence. A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    fitted = _fitted(t, dim, parts)
    return t if fitted is t else _GradOnPlacements.apply(fitted)


def _fitted(t, dim: int, parts: int):
    from torch.distributed.tensor import Replicate, Shard

    dim %= t.ndim
    want, n = list(t.placements), 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= t.device_mesh.size(i)
            if parts % n:
                want[i] = Replicate()
    return t if want == list(t.placements) else redistribute(t, want)


class _GradFitted(torch.autograd.Function):
    """The identity forward; backward, the gradient fitted (`fit_split`)
    for the split that undoes the forward's merge."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad):
            grad = _fitted(grad, ctx.dim, ctx.parts)
        return grad, None, None


def fit_merged(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """A DTensor whose dim `dim` was just merged from (`parts`, ...): its
    gradient is fitted as `fit_split` fits a tensor before the backward
    pass splits it back. A plain tensor as it is."""
    return _GradFitted.apply(t, dim, parts) if is_dtensor(t) else t


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


_ROW_GROUPS: Dict[tuple, object] = {}  # (world, mesh, dims) -> group


def _rows_group(mesh, dims: tuple):
    """(process group, size) of the ranks that share this rank's
    coordinates off the mesh dims `dims`, ordered row-major over `dims`:
    one mesh dim's own group, or for several a group of their ranks made
    once a world (every rank makes every such group, in one order). Not
    the mesh's flattened sub-mesh: the device mesh keeps those across
    process groups, and a later world would meet the old one's group."""
    import torch.distributed as dist

    size = 1
    for i in dims:
        size *= mesh.size(i)
    if len(dims) == 1:
        return mesh.get_group(dims[0]), size
    key = (dist.group.WORLD, mesh, dims)
    if key not in _ROW_GROUPS:
        others = [d for d in range(mesh.ndim) if d not in dims]
        ranks = np.array(mesh.mesh.tolist()).transpose(
            others + list(dims)).reshape(-1, size)  # numpy: host work
        me = dist.get_rank()
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                _ROW_GROUPS[key] = group
    return _ROW_GROUPS[key], size


def _row_owner(mesh, dims: tuple, n: int, index: int):
    """Where row `index` of a dim of `n` rows split over the mesh dims
    `dims` (``torch.chunk``'s split, in mesh-dim order) lives: (its
    owner's place in `_rows_group`'s order, the row's index in the owner's
    shard, whether this rank is the owner)."""
    start, owner, mine = 0, 0, True
    for i in dims:
        chunk = -(-n // mesh.size(i))
        c = (index - start) // chunk
        start += c * chunk
        n = max(0, min(chunk, n - c * chunk))
        owner = owner * mesh.size(i) + c
        mine = mine and mesh.get_local_rank(i) == c
    return owner, index - start, mine


class _StackRow(torch.autograd.Function):
    """Row `index` of a DTensor `stack` whose dim 0 is split over some mesh
    dims: the owner's local row broadcast over those dims' group; backward,
    the row's gradient (a pending sum over those dims, or replicated there)
    reduced onto the owner's row of a zero gradient of the stack."""

    @staticmethod
    def forward(ctx, stack, index):
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard

        mesh, local = stack.device_mesh, stack.to_local()
        dims = tuple(i for i, p in enumerate(stack.placements)
                     if p.is_shard() and p.dim % stack.ndim == 0)
        row_pl = [Replicate() if i in dims else Shard(p.dim % stack.ndim - 1)
                  if p.is_shard() else p
                  for i, p in enumerate(stack.placements)]
        owner, at, mine = _row_owner(mesh, dims, stack.shape[0], index)
        out = local[at].clone() if mine else local.new_empty(local.shape[1:])
        group, size = _rows_group(mesh, dims) if dims else (None, 1)
        if size > 1:
            dist.broadcast(out, src=dist.get_global_rank(group, owner),
                           group=group)
        ctx.dims, ctx.row_pl, ctx.at, ctx.mine = dims, row_pl, at, mine
        ctx.owner, ctx.group, ctx.size = owner, group, size
        ctx.stack = (mesh, tuple(stack.placements), tuple(stack.shape),
                     tuple(local.shape))
        return wrap(out, mesh, row_pl, shape=tuple(stack.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        mesh, placements, shape, local_shape = ctx.stack
        pending = bool(ctx.dims) and all(
            grad.placements[i].is_partial() for i in ctx.dims)
        want = [grad.placements[i] if pending and i in ctx.dims else p
                for i, p in enumerate(ctx.row_pl)]
        g = redistribute(grad, want).to_local()
        if pending and ctx.size > 1:
            g = g.contiguous().clone()
            dist.reduce(g, dst=dist.get_global_rank(ctx.group, ctx.owner),
                        group=ctx.group)
        out = g.new_zeros(local_shape)
        if ctx.mine:
            out[ctx.at] = g
        return wrap(out, mesh, placements, shape=shape), None


def stack_row(stack: torch.Tensor, index: int) -> torch.Tensor:
    """Row `index` of a stacked parameter (`optim.tree.stack_leaves`): a
    plain tensor's ``stack[index]``. A DTensor's rows may be split over
    mesh dims (FSDP's fold of ('pod', 'data') onto the layer axis): the
    rank holding the row broadcasts its shard of it over the ranks that
    split the rows (one broadcast of the row's shard, never the stack
    gathered, as DTensor's select does), the row laid out as the layer's
    own tensor is (those mesh dims replicated, its other dims' shards
    kept); backward reduces the row's gradient onto the owner's row of the
    stack's gradient, every other row zeros (``torch.distributed``'s
    ``broadcast`` and ``reduce``, on their process groups)."""
    if not is_dtensor(stack):
        return stack[index]
    return _StackRow.apply(stack, index)


def _first_row(mesh, sharded, n: int) -> int:
    """The first of the `n` rows this rank holds of a dim split over the
    mesh dims flagged in `sharded` (``torch.chunk``'s split, in mesh-dim
    order)."""
    lo = 0
    for i, v in enumerate(sharded):
        if v:
            chunk = -(-n // mesh.size(i))
            lo += chunk * mesh.get_local_rank(i)
            n = max(0, min(chunk, n - chunk * mesh.get_local_rank(i)))
    return lo


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
    lo = _first_row(mesh, vocab, table.shape[0])
    groups = [mesh.get_group(i) for i, v in enumerate(vocab)
              if v and mesh.size(i) > 1]
    local_table = _local(table, [Partial() if isinstance(pi, Shard) else pt
                                 for pt, pi in zip(want_t, want_i)])
    rows = _VocabShardLookup.apply(local_table, ids.to_local(), lo, groups)
    return wrap(rows, mesh, want_i,
                shape=tuple(ids.shape) + (table.shape[1],))


class _VocabShardNLL(torch.autograd.Function):
    """``-log_softmax(logits)[targets]`` of this rank's vocab columns
    ``[lo, lo + V_local)`` of the logits, the softmax's max and sum and the
    picked target logit reduced over `groups` (the vocab shards).
    Backward: ``(softmax - onehot) * grad`` on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, lo, groups):
        import torch.distributed as dist

        m = logits.amax(-1)
        for group in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        z = logits - m[..., None]
        e = torch.exp(z)
        total = e.sum(-1)
        inside = (targets >= lo) & (targets < lo + logits.shape[-1])
        local = torch.where(inside, targets - lo, torch.zeros_like(targets))
        picked = torch.where(inside, torch.gather(z, -1, local[..., None])[
            ..., 0], torch.zeros_like(m))
        for group in groups:
            dist.all_reduce(total, group=group)
            dist.all_reduce(picked, group=group)
        ctx.save_for_backward(e, total, local, inside)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, grad):
        e, total, local, inside = ctx.saved_tensors
        onehot = torch.zeros_like(e).scatter_(
            -1, local[..., None], inside[..., None].to(e.dtype))
        return (e / total[..., None] - onehot) * grad[..., None], None, \
            None, None


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``-log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]``
    of DTensor logits whose last dim (the vocabulary) is sharded over some
    mesh dims: each rank works on its own columns and reduces the
    softmax's max and sum and the target's logit over those mesh dims (an
    all-reduce of (..,) rows, not a gather of the logits). The other
    leading dims keep their sharding (the batch over 'data'), and so does
    the result; `targets` (plain or DTensor) is laid out to match. On no
    vocab sharding it is the unsharded formula on the local rows."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard

    mesh, last = logits.device_mesh, logits.ndim - 1
    if not is_dtensor(targets):
        targets = replicated_value(targets, mesh)
    vocab = [isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1
             for i, p in enumerate(logits.placements)]
    want_l = [Shard(last) if v else p if isinstance(p, Shard)
              and p.dim != last else Replicate()
              for v, p in zip(vocab, logits.placements)]
    want_t = [Replicate() if v else p for v, p in zip(vocab, want_l)]
    logits = redistribute(logits, want_l)
    targets = redistribute(targets, want_t)
    local_logits, local_t = _local(logits, want_l), targets.to_local()
    if not any(vocab):
        logp = F.log_softmax(local_logits, dim=-1)
        nll = -torch.gather(logp, -1, local_t[..., None])[..., 0]
    else:
        groups = [mesh.get_group(i) for i, v in enumerate(vocab) if v]
        nll = _VocabShardNLL.apply(local_logits, local_t, _first_row(
            mesh, vocab, logits.shape[-1]), groups)
    return wrap(nll, mesh, want_t, shape=tuple(targets.shape))


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` redistributed to `ref`'s placements when both are DTensors, a
    pending sum of `ref`'s read as replicated (DTensor keeps a residual
    stream ``Partial`` after an add, and refuses to redistribute to one):
    a gradient's pending data-axis ``Partial(sum)`` becomes the reduced
    gradient on its parameter's layout; an activation goes back to the
    residual's."""
    if not (is_dtensor(t) and is_dtensor(ref)):
        return t
    from torch.distributed.tensor import Replicate

    return redistribute(t, [Replicate() if p.is_partial() else p
                            for p in ref.placements])


def index_copy_(cache: torch.Tensor, dim: int, rows: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """``cache.index_copy_(dim, rows, new)`` on a DTensor `cache` (a decode
    cache's write at its index), in place, which DTensor has no rule for:
    `new` is laid out as `cache` but whole along `dim`, and each rank
    writes into its own shard. Where `dim` is not sharded every rank
    copies all `rows`; where it is (an MLA latent's sequence, on 'model')
    each rank keeps its shard's rows that `rows` names and takes the rest
    from `new` (a select over the shard: no row of `rows` falls twice)."""
    from torch.distributed.tensor import Replicate

    dim %= cache.ndim
    along = [pl.is_shard() and pl.dim % cache.ndim == dim
             for pl in cache.placements]
    new = new.to(cache.dtype)
    if not is_dtensor(new):
        new = replicated_value(new, cache.device_mesh)
    if is_dtensor(rows):
        rows = replicate(rows).to_local()
    src = redistribute(new, [
        Replicate() if a or pl.is_partial() else pl
        for a, pl in zip(along, cache.placements)]).to_local()
    local = cache.to_local()
    if not any(along):
        local.index_copy_(dim, rows, src)
        return cache
    first = local_offset(cache.shape, cache.device_mesh, cache.placements,
                         dim)
    pos = first + torch.arange(local.shape[dim], device=local.device)
    hit = pos[:, None] == rows[None, :]  # (local rows, rows)
    pick = src.index_select(dim, hit.to(torch.int32).argmax(1))
    keep = hit.any(1).reshape([-1 if d == dim else 1
                               for d in range(local.ndim)])
    local.copy_(torch.where(keep, pick, local))
    return cache


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


def batch_local(fn: Callable, *args, batched):
    """``fn(*args)`` for a region independent across the batch: the
    arguments at the positions `batched` hold the batch on dim 0, the others
    are shared (weights). On DTensors it runs on this rank's rows: each
    batched argument laid out as the first batched DTensor holds its batch
    (the mesh dims sharding its dim 0 kept, every other dim replicated), the
    shared ones replicated, and each tensor `fn` returns (the batch on dim
    0) comes back a DTensor laid out so: one region instead of a DTensor op
    each (the sLSTM's step-by-step recurrence). Differentiable; a shared
    argument's gradient is a partial sum over the batch's mesh dims.
    Without batched DTensors it is ``fn(*args)``."""
    ref = next((args[i] for i in batched if is_dtensor(args[i])), None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ref.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in ref.placements]
    partial = [Partial() if isinstance(p, Shard) else p for p in rows]
    local = []
    for i, a in enumerate(args):
        if i in batched:
            local.append(_local(redistribute(a, rows), rows)
                         if is_dtensor(a) else local_chunk(a, mesh, rows))
        else:
            local.append(_local(replicate(a), partial) if is_dtensor(a)
                         else a)
    out = fn(*local)

    def back(t):
        return wrap(t.contiguous(), mesh, rows,
                    shape=(ref.shape[0],) + tuple(t.shape[1:]))

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
    operand's own free letter like the vocab of the logits; a letter may
    keep several mesh dims, as the batch keeps ('pod', 'data')): every
    operand holding that letter is redistributed to be sharded on it, every
    other
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
                # a letter may stay sharded over several mesh dims (the
                # batch over ('pod', 'data')) where an operand holds it so
                if c in out and len(sizes[c]) == 1 and (
                        c not in keep or all(
                            isinstance(op.placements[j], Shard)
                            and term[op.placements[j].dim] == c
                            for j, k in enumerate(keep) if k == c)):
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
    ways = {}
    for i, c in enumerate(keep):
        if c is not None:
            ways[c] = ways.get(c, 1) * mesh.size(i)
    if all(max(sizes[c]) % n == 0 for c, n in ways.items()):
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
