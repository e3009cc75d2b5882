"""Logical-axis sharding rules (port of `repro.sharding.rules`): parameter,
cache and batch trees -> partition specs, and a spec -> DTensor placements.

Mesh axes:
  * 'pod'   — cross-pod data parallelism (multi-pod mesh only)
  * 'data'  — within-pod data parallelism
  * 'model' — tensor/expert parallelism (heads, d_ff, vocab, experts)

A spec is `repro`'s ``PartitionSpec`` as a tuple: per dim ``None``, an axis
name, or a tuple of names (a tuple of one name is that name, as
``PartitionSpec`` normalizes it). Rules match the leaf's last key and apply
to the TRAILING dims, so `repro`'s layer-stacking prefixes are transparent.
Anything unmatched is replicated.

The rules run on `repro`'s leaves (`optim.tree.leaves`: a stacked subtree's
per-layer tensors are one leaf, its shape the stacked axes then the
layer's), so every ``*_pspecs`` returns ``{keystr: spec}`` equal to
`repro`'s tree of specs leaf for leaf. `tensor_pspecs` gives each port
tensor its spec: a layer's tensor has no stacked prefix, so its spec is the
leaf's with the ``len(Leaf.lead)`` leading entries dropped.

A mesh is anything with axis names (``axis_names``, or a torch
``DeviceMesh``'s ``mesh_dim_names``) and a shape (a tuple, a name -> size
mapping, or ``devices.shape``): the rules need no devices. `to_placements`
and `to_shardings` place specs on a ``torch.distributed`` ``DeviceMesh``
(`launch.mesh.make_process_mesh`):

  =====================  ===========================================
  `repro`                port (DTensor placements, one per mesh dim)
  =====================  ===========================================
  a dim named 'model'    ``Shard(dim)`` on the model mesh dim
  an unnamed dim         ``Replicate()``
  ('pod', 'data')        ``Shard(dim)`` on each, major first
  =====================  ===========================================
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, NamedTuple, Optional, Tuple

from repro_torch.optim.tree import leaves, named_tensors

Spec = Tuple[Any, ...]

# leaf-name -> trailing-dims spec (None entries replicate that dim)
_PARAM_TRAILING_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / output heads: (vocab, d) — vocab on model (sharded logits)
    ("embed", ("model", None)),
    ("unembed", ("model", None)),
    ("enc_pos", (None, None, None)),
    ("dec_pos", (None, None, None)),
    # MoE experts: (E, d, f) / (E, f, d) — expert parallelism over model
    ("w_gate_e", ("model", None, None)),
    ("w_in_e", ("model", None, None)),
    ("w_out_e", ("model", None, None)),
    ("router", (None, None)),
    # attention / FFN / SSM in-projections: (d, out) — out on model
    ("wq", (None, "model")),
    ("wk", (None, "model")),
    ("wv", (None, "model")),
    ("w_in", (None, "model")),
    ("w_gate", (None, "model")),
    ("w_up", (None, "model")),
    ("w_uk", (None, "model")),
    ("w_uv", (None, "model")),
    ("w_dkv", (None, None)),  # small LoRA-down: replicate
    ("w_krope", (None, None)),
    ("w_gates", (None, "model")),
    # out-projections: (in, d) — in on model
    ("wo", ("model", None)),
    ("w_out", ("model", None)),
    ("w_down", ("model", None)),
    # biases matching a model-sharded output
    ("bq", ("model",)),
    ("bk", ("model",)),
    ("bv", ("model",)),
    ("b_in", ("model",)),
    ("b_out", (None,)),
    # mamba2 / conv
    ("conv_w", (None, "model")),
    ("conv_b", ("model",)),
    ("a_log", ("model",)),
    ("dt_bias", ("model",)),
    ("d_skip", ("model",)),
    # xlstm sLSTM recurrent weights: few heads — replicate
    ("r_gates", (None, None, None, None)),
    ("b_gates", (None, None)),
    ("gate_bias", (None,)),
    ("gate_attn", ()),
    ("gate_ffn", ()),
    # norms
    ("scale", (None,)),
    ("bias", (None,)),
)

_PARAM_RULES = dict(_PARAM_TRAILING_RULES)

_EXPERT_2D_RULES = {
    # 2D expert sharding: E over model AND the FFN dim over data — at 100B+
    # total expert params, 1D EP leaves ~50 GB/chip of weights; 2D brings it
    # to params/(model*data).
    "w_gate_e": ("model", None, "data"),
    "w_in_e": ("model", None, "data"),
    "w_out_e": ("model", "data", None),
}

# The decode-cache subtrees `repro` stacks on leading axes, by family (the
# port keeps one entry per layer in lists): path -> number of stacked axes.
_CACHE_STACKED = {
    "hybrid": {("units",): 2, ("tail",): 1},
    "ssm": {("mlstm",): 2, ("slstm",): 1},
    "audio": {("self_kv",): 1},
    "vlm": {("self_kv",): 2},
}


class Sharding(NamedTuple):
    """Where one tensor lives on a process mesh: the port's
    ``NamedSharding``."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    placements: tuple  # one DTensor placement per mesh dim


def _spec(entries) -> Spec:
    """``tuple(PartitionSpec(*entries))``: a tuple of one axis name is the
    name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (see the module docstring)."""
    names = getattr(mesh, "axis_names", None) or getattr(
        mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"{type(mesh).__name__} names no mesh axes")
    shape = getattr(mesh, "shape", None)
    if shape is None:
        shape = mesh.devices.shape
    if isinstance(shape, Mapping):
        shape = [shape[n] for n in names]
    return dict(zip(names, (int(s) for s in shape)))


def _dp(sizes: Dict[str, int]) -> Tuple[tuple, int]:
    """The data-parallel axes (('pod', 'data') or ('data',)) and their
    product."""
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in dp:
        n *= sizes[a]
    return dp, n


_TOKEN = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|\.(\w+)")


def key_tokens(key: str) -> list:
    """The path tokens of a ``jax.tree_util.keystr`` (dict keys, list
    indices and NamedTuple fields, as strings), as `repro`'s
    ``_path_tokens`` gives them."""
    return [a or b or c for a, b, c in _TOKEN.findall(key)]


def _fit(trailing, ndim: int, axis_ok) -> Spec:
    """Apply a trailing-dim rule to an ndim-array (prefix dims replicated),
    dropping axes that don't divide evenly (checked by axis_ok)."""
    spec = [None] * (ndim - len(trailing)) + [
        a if (a is None or axis_ok(a, i)) else None
        for i, a in enumerate(trailing)
    ]
    return _spec(spec)


def _leaf_shapes(tree, stacked=None):
    """(keystr, stacked shape) of every `repro` leaf of `tree`."""
    named = named_tensors(tree)
    return [(leaf.key, tuple(leaf.lead) + tuple(named[leaf.names[0]].shape))
            for leaf in leaves(tree, stacked)]


def leaf_spec(name: str, shape, mesh, *, expert_2d: bool = False) -> Spec:
    """The spec of one parameter named `name` (its last key) of `shape` on
    `mesh`: the rule of that name fitted to the trailing dims, ``()``
    (replicated) where none matches. A leaf's spec depends on nothing
    else, so a layer's tensors can be placed as they are drawn."""
    sizes = axis_sizes(mesh)
    trailing = (expert_2d and _EXPERT_2D_RULES.get(name)) or \
        _PARAM_RULES.get(name)
    ndim = len(shape)
    if trailing is None or len(trailing) > ndim:
        return ()  # replicate unmatched

    def ok(axis, i):
        return shape[ndim - len(trailing) + i] % sizes.get(axis, 1) == 0

    return _fit(trailing, ndim, ok)


def param_pspecs(params, mesh, *, expert_2d: bool = False) -> Dict[str, Spec]:
    """{keystr: spec} for a parameter tree (a family module, on any device
    including ``meta``), `repro`'s `param_pspecs` leaf for leaf."""
    return {key: leaf_spec(key_tokens(key)[-1], shape, mesh,
                           expert_2d=expert_2d)
            for key, shape in _leaf_shapes(params)}


def batch_pspecs(batch, mesh) -> Dict[str, Spec]:
    """Inputs: batch dim over all DP axes (('pod','data') or ('data',)); a
    batch that does not divide replicates. `batch` maps names to anything
    with a ``shape``."""
    dp, dp_size = _dp(axis_sizes(mesh))

    def spec_of(shape):
        if len(shape) == 0 or shape[0] % dp_size != 0:
            return ()  # tiny batches (long_500k B=1): replicate
        return _spec((dp,) + (None,) * (len(shape) - 1))

    return {name: spec_of(tuple(x.shape)) for name, x in batch.items()}


def cache_stacked(cfg, cache) -> Dict[tuple, int]:
    """The subtrees of a port decode cache that `repro` stacks, with their
    number of stacked axes."""
    if cfg.family in ("dense", "moe"):
        return {("units", name): 1 for name in cache["units"]}
    return dict(_CACHE_STACKED[cfg.family])


def cache_pspecs(cfg, cache, mesh) -> Dict[str, Spec]:
    """{keystr: spec} of a port decode cache (`Model.init_cache`, on any
    device including ``meta``), `repro`'s `cache_pspecs` leaf for leaf (the
    0-d ``index`` replicated, ``()``). KV caches shard batch over DP and one of {kv_heads, head_dim,
    seq} over model (first that divides); SSM/xLSTM states shard their wide
    feature dim over model."""
    sizes = axis_sizes(mesh)
    dp, dp_size = _dp(sizes)
    m = sizes.get("model", 1)

    def spec_of(key, shape):
        toks = key_tokens(key)
        name = toks[-1]
        nd = len(shape)
        if nd == 0:
            return ()

        def with_batch(batch_dim, extra: dict):
            spec = [None] * nd
            if shape[batch_dim] % dp_size == 0:
                spec[batch_dim] = dp
            for d, a in extra.items():
                if shape[d] % sizes.get(a, 1) == 0:
                    spec[d] = a
            return _spec(spec)

        if name in ("index",):
            return ()
        if name == "conv":  # (..., B, K-1, C): channels on model
            return with_batch(nd - 3, {nd - 1: "model"})
        if name == "ssd":  # (..., B, H, N, P): ssm heads on model
            return with_batch(nd - 4, {nd - 3: "model"})
        if name == "mem":  # (..., B, H, P, P+1): shard P (k-dim) on model
            return with_batch(nd - 4, {nd - 2: "model"})
        if name in ("h", "c", "n", "m"):  # sLSTM: (..., B, H, P)
            return with_batch(nd - 3, {})
        if name in ("enc_out", "image_embeds"):  # (B, S, D)
            return with_batch(0, {})
        if cfg.mla is not None and nd >= 3 and toks and "kv" in "/".join(toks):
            # MLA latent: (..., B, S, r) — batch only (latent is shared)
            return with_batch(nd - 3, {})
        if nd >= 4:  # KV: (..., B, S, Hkv, hd)
            batch_dim = nd - 4
            for d in (nd - 2, nd - 1, nd - 3):  # heads, head_dim, seq
                if shape[d] % m == 0 and m > 1:
                    return with_batch(batch_dim, {d: "model"})
            return with_batch(batch_dim, {})
        if nd >= 3:
            return with_batch(nd - 3, {})
        return ()

    return {key: spec_of(key, shape) for key, shape in
            _leaf_shapes(cache, cache_stacked(cfg, cache))}


def _axes(spec) -> set:
    """The mesh axes a spec names."""
    used = set()
    for e in spec:
        if e is not None:
            used.update((e,) if isinstance(e, str) else tuple(e))
    return used


def _fold_dp(shape, spec, dp: tuple, dp_size: int) -> Spec:
    """`spec` (entries for the leading dims of `shape`) with the DP axes
    folded onto the first still-unsharded dim of `shape` that they divide,
    unless a dim already names one of them (a 2-D expert shard)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if _axes(entries) & set(dp):  # DP axes already consumed (2-D experts)
        return _spec(entries)
    for dim in range(len(shape)):
        if entries[dim] is None and shape[dim] % dp_size == 0 \
                and shape[dim] >= dp_size:
            entries[dim] = dp
            break
    return _spec(entries)


def _fold_onto_model(shape, spec, dp: tuple, size: int) -> Spec:
    """`spec` with the DP axes folded jointly with 'model' onto the first
    dim it shards on 'model' alone, as ``(*dp, 'model')`` (DP major), where
    `size` (dp x model) divides that dim; else `spec` as it is."""
    entries = list(spec)
    for dim, e in enumerate(entries):
        if e == "model" and shape[dim] % size == 0:
            entries[dim] = tuple(dp) + ("model",)
            break
    return _spec(entries)


def zero1_pspecs(params, mesh, *, expert_2d: bool = False) -> Dict[str, Spec]:
    """ZeRO-1: optimizer-moment specs = param specs + the DP axes folded onto
    the first still-unsharded divisible dim (a stacked layer axis included,
    as in `repro`). Cuts f32 moment memory by the DP degree."""
    dp, dp_size = _dp(axis_sizes(mesh))
    base = param_pspecs(params, mesh, expert_2d=expert_2d)
    return {key: _fold_dp(shape, base[key], dp, dp_size)
            for key, shape in _leaf_shapes(params)}


def _zero1_layers(params, mesh, expert_2d: bool):
    """(leaf, `zero1_pspecs`' spec of the leaf, the spec of each of its
    port tensors, whether that spec holds `repro`'s bytes) for every
    `repro` leaf of `params` (see `zero1_tensor_pspecs`)."""
    sizes = axis_sizes(mesh)
    dp, dp_size = _dp(sizes)
    base = param_pspecs(params, mesh, expert_2d=expert_2d)
    named = named_tensors(params)
    for leaf in leaves(params):
        n = len(leaf.lead)
        layer = tuple(named[leaf.names[0]].shape)
        spec = tuple(_fold_dp(tuple(leaf.lead) + layer, base[leaf.key], dp,
                              dp_size))  # `zero1_pspecs`' leaf
        if not any(e is not None for e in spec[:n]):
            yield leaf, spec, spec[n:], True
            continue
        own = tuple(base[leaf.key]) + (None,) * (n + len(layer)
                                                 - len(base[leaf.key]))
        per_layer = _fold_dp(layer, own[n:], dp, dp_size)
        if not _axes(per_layer) & set(dp):
            per_layer = _fold_onto_model(layer, per_layer, dp,
                                         dp_size * sizes.get("model", 1))
        yield leaf, spec, per_layer, bool(_axes(per_layer) & set(dp))


def zero1_tensor_pspecs(params, mesh, *, expert_2d: bool = False
                        ) -> Dict[str, Spec]:
    """{port tensor name: spec} of `zero1_pspecs` (the ZeRO-1 moments, and
    the parameters under FSDP). Where `repro` folds the DP axes onto a
    stacked layer axis, the port, which holds one tensor a layer, folds
    them onto the first still-unsharded dim of each layer's tensor that
    they divide: the same bytes a device (L/dp layers whole, or L layers
    each cut dp ways). A layer with no such dim (a bias already on 'model')
    takes them jointly with 'model' on its model-sharded dim, (*dp,
    'model'), where dp x model divides it: the same bytes again. Where
    neither divides (whisper's 1280-wide biases on 2x16x16) the tensor
    keeps its parameter spec: its moments are stacked instead
    (`zero1_stacked_pspecs`), its FSDP parameter stays as it is (ROADMAP
    C27)."""
    out = {}
    for leaf, _, per_layer, _ in _zero1_layers(params, mesh, expert_2d):
        for name in leaf.names:
            out[name] = per_layer
    return out


def zero1_stacked_pspecs(params, mesh, *, expert_2d: bool = False
                         ) -> Dict[str, Spec]:
    """{keystr: `zero1_pspecs`' spec} of the `repro` leaves whose ZeRO-1
    moments no per-layer placement holds in `repro`'s bytes (whisper's
    1280-wide q/k/v biases on 2x16x16: 512 does not divide 1280): the
    optimizer keeps their moments as one stacked ``(*lead, ...)`` tensor a
    leaf on this spec, the layer axis cut over the DP axes as `repro` cuts
    it (`optim.optimizer.zero1_opt_state`)."""
    return {leaf.key: spec for leaf, spec, _, held in
            _zero1_layers(params, mesh, expert_2d) if not held}


def tensor_pspecs(tree, leaf_specs: Dict[str, Spec],
                  stacked=None) -> Dict[str, Spec]:
    """{port tensor name: spec}: each `repro` leaf's spec with its stacked
    prefix dropped, for every tensor stacked into it. A spec that shards a
    stacked layer axis has no per-layer form and raises (`zero1_pspecs`'
    fold has one: `zero1_tensor_pspecs`)."""
    out = {}
    for leaf in leaves(tree, stacked):
        spec = tuple(leaf_specs[leaf.key])
        n = len(leaf.lead)
        if any(e is not None for e in spec[:n]):
            raise ValueError(f"{leaf.key}: spec {spec} shards a stacked "
                             f"layer axis; the port holds one tensor per "
                             f"layer")
        for name in leaf.names:
            out[name] = spec[n:]
    return out


def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of `spec` on a ``DeviceMesh`` with named
    dims: ``Shard(dim)`` on each mesh dim a tensor dim names (a tuple of
    names in the mesh's order, major first), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names or ())
    placements = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names {missing}, not axes of the "
                             f"mesh {names}")
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: {axes} are not in the mesh's "
                             f"order {names}")
        for i in where:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]} twice")
            placements[i] = Shard(dim)
    return tuple(placements)


def to_shardings(specs: Dict[str, Spec], mesh) -> Dict[str, Sharding]:
    """{name: Sharding} of a {name: spec} map (`tensor_pspecs`,
    `batch_pspecs`) on a ``DeviceMesh``."""
    return {name: Sharding(mesh, to_placements(spec, mesh))
            for name, spec in specs.items()}


def param_shardings(params, mesh, *, expert_2d: bool = False,
                    specs: Optional[Dict[str, Spec]] = None
                    ) -> Dict[str, Sharding]:
    """{port tensor name: Sharding} of a parameter tree on `mesh` by
    `param_pspecs` (or the leaf `specs` given)."""
    if specs is None:
        specs = param_pspecs(params, mesh, expert_2d=expert_2d)
    return to_shardings(tensor_pspecs(params, specs), mesh)
