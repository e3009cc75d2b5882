"""Per-family model assembly (port of `repro.models.transformer`).

Every family is an `nn.Module` (a `ParamDict` whose parameters carry
`repro`'s leaf names) with the methods of `repro`'s builders:
  forward(batch, rt)                 -> (logits, aux) for the full sequence
  init_cache(batch_size, max_len, rt, device=None) -> decode cache
  decode_step(tokens, cache, rt)     -> (logits of the last position, cache)
and each ``build_*`` returns `repro`'s tuple of functions
``(init, forward, init_cache, decode_step)`` over them, with
``init(generator, device=None)`` drawing the parameters.

`repro` stacks each repeating unit's parameters on a leading axis and scans
them (`_stack_init`, `_scan_layers`); the port keeps one module per layer in
lists (``units.pos0.3.attn.wq``) and runs the layers in a Python loop in
`repro`'s order. `Runtime.scan_layers` is accepted and changes nothing
(`repro`'s own test pins that scanning and unrolling agree). `Runtime.remat`
checkpoints each layer that `repro` scans (its `_maybe_remat` wraps the
scan body) while autograd records: ``"full"`` recomputes the whole layer in
the backward pass, ``"dots"`` keeps the un-batched matmuls' outputs (the
weight GEMMs, `aten.mm`/`aten.addmm`) and recomputes the rest, as
``dots_with_no_batch_dims_saveable`` does.

Caches mirror the parameters: per-layer (k, v) tensors in lists, written in
place by each decode step (as `models.paged_kv` does; `repro` returns a new
cache), and ``cache["index"]`` is a Python int.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import resolve_device
from repro_torch.sharding.dtensor import is_dtensor, like, shard_on
from . import layers as L
from . import moe as M
from . import ssm as S
from . import xlstm as X


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution options orthogonal to the architecture (`repro`'s fields).

    ``embed_backend`` names the port's gather backends: ``index`` (`repro`'s
    ``jnp``: ``table[ids]``), ``coalesced`` (the schedule executed in torch;
    `repro`'s ``coalesced``), ``cuda`` (the hand-written `coalesced_gather`
    kernel; `repro`'s ``pallas``) or ``auto`` (cuda on the card, coalesced
    on the CPU). ``remat`` checkpoints each scanned layer under autograd and
    ``scan_layers`` changes nothing (see the module docstring).

    Two layout levers act on a process mesh (DTensor activations) and
    change nothing on plain tensors: ``seq_shard_attention`` shards the
    query sequence over 'model' before attention in training and prefill
    (`_apply_dense_layer`), so the scores are cut on their query dim;
    ``moe_ep_constraint`` pins the data-local dispatch buffer and the
    experts' output to ('data', 'model') (`moe.moe_apply`, with
    ``moe_dp_shards`` > 1). A lever that cannot be applied on a mesh
    raises."""

    remat: str = "none"  # none | full | dots
    embed_backend: str = "index"  # index | coalesced | cuda | auto
    embed_window: int = 256
    embed_block_rows: int = 8
    moe_capacity_factor: float = 1.25
    cache_dtype: str = "bfloat16"
    scan_layers: bool = True
    moe_dp_shards: int = 1  # data-local MoE dispatch (per DP shard)
    moe_ep_constraint: bool = False  # pin the EP layout on a mesh
    seq_shard_attention: bool = False  # SP: shard seq over 'model' (mesh)


def torch_dtype(name) -> torch.dtype:
    """A dtype name of a config or a `Runtime` ("bfloat16") as a torch
    dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Parameter trees as modules
# ---------------------------------------------------------------------------


class ParamList(nn.ModuleList):
    """A list of parameter subtrees (one per layer or unit)."""

    def __init__(self, items=()):
        super().__init__([_as_module(v) for v in items])

    def to_tree(self) -> list:
        return [m.to_tree() for m in self]


class ParamDict(nn.Module):
    """A mapping of `repro`'s leaf names to parameters and subtrees:
    ``p["wq"]``, ``"bq" in p``, ``p.keys()``, as the layer functions read a
    dict. Parameters require grad: serving runs under
    `torch.inference_mode`, training differentiates them."""

    def __init__(self, tree: Optional[dict] = None):
        super().__init__()
        self._names: List[str] = []
        for name, value in (tree or {}).items():
            self._names.append(name)
            if torch.is_tensor(value):
                self.register_parameter(name, nn.Parameter(value))
            else:
                self.add_module(name, None if value is None
                                else _as_module(value))

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._names

    def keys(self):
        return list(self._names)

    def items(self):
        return [(n, self[n]) for n in self._names]

    def like(self, tree: dict) -> "ParamDict":
        """A module of this one's class (and config) holding `tree`, a
        nested dict of this one's structure: optimizer moments, gradients."""
        return type(self)(tree)

    def to_tree(self) -> dict:
        """The nested dict of tensors (and lists, and None) this holds."""
        out = {}
        for name, value in self.items():
            if value is None:
                out[name] = None
            elif isinstance(value, nn.Parameter):
                out[name] = value.data
            else:
                out[name] = value.to_tree()
        return out


def _as_module(value):
    if isinstance(value, nn.Module):
        return value
    if isinstance(value, dict):
        return ParamDict(value)
    if isinstance(value, (list, tuple)):
        return ParamList(value)
    raise TypeError(f"cannot hold {type(value).__name__} in a parameter tree")


def _dots_policy(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: save the un-batched matmuls."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _layer(rt: "Runtime", fn: Callable, *args):
    """``fn(*args)`` for one layer `repro` scans, under `rt.remat` while
    autograd records (`repro`'s `_maybe_remat`)."""
    if rt.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if rt.remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if rt.remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat must be none, full or dots, got {rt.remat!r}")


# what `_Family.init` places each layer with as it is drawn, while it runs
_PLACE: contextvars.ContextVar = contextvars.ContextVar("place",
                                                        default=None)


def _drawn(layer):
    """A layer's tree as soon as it is drawn, through the ``place`` of
    `_Family.init` when one is set."""
    place = _PLACE.get()
    return layer if place is None else place(layer)


def _stack_init(init_one: Callable[[], Any], n: int) -> list:
    """`repro` vmaps an init over n split keys into one stacked tree; here n
    trees, drawn in turn from the one generator, each `_drawn` before the
    next."""
    return [_drawn(init_one()) for _ in range(n)]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _cache_dtype(rt: Runtime) -> torch.dtype:
    return torch_dtype(rt.cache_dtype)


def _positions(index: int, sq: int, device) -> torch.Tensor:
    return (index + torch.arange(sq, device=device))[None, :]


class _Family(ParamDict):
    """A model family: its config beside its parameter tree."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def like(self, tree: dict) -> "_Family":
        return type(self)(self.cfg, tree)

    @property
    def device(self) -> torch.device:
        return self.tok.embed.device

    @classmethod
    def init(cls, cfg: ArchConfig, generator: Optional[torch.Generator] = None,
             device=None, place: Optional[Callable] = None):
        """Parameters drawn from `generator` on `device` (default the card;
        the generator must live there; default: seed 0). `place` (a tree
        -> tree, `sharding.dtensor.place_tree` on a mesh) takes each layer
        as soon as it is drawn, then the whole tree: the draws are the
        same, and no more than one layer and the parameters outside the
        layers are ever whole at once."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        token = _PLACE.set(place)
        try:
            tree = cls.init_tree(cfg, generator, device)
        finally:
            _PLACE.reset(token)
        return cls(cfg, tree if place is None else place(tree))

    def _embed(self, tokens, rt: Runtime):
        # `repro`'s non-decoder families embed at the default window and
        # block rows, not the runtime's
        return L.embedding_apply(self.tok, tokens, backend=rt.embed_backend)


def _builder(cls, cfg: ArchConfig):
    """`repro`'s builder tuple over a family module class."""

    def init(generator=None, device=None, place=None):
        return cls.init(cfg, generator, device, place)

    def forward(p, batch, rt: Runtime):
        return p.forward(batch, rt)

    def init_cache(Bsz: int, s_max: int, rt: Runtime, device=None):
        return cls.empty_cache(cfg, Bsz, s_max, rt, resolve_device(device))

    def decode_step(p, tokens, cache, rt: Runtime):
        return p.decode_step(tokens, cache, rt)

    return init, forward, init_cache, decode_step


# ---------------------------------------------------------------------------
# Shared building blocks
# ---------------------------------------------------------------------------


def _init_dense_layer(cfg: ArchConfig, gen, device, d_ff: Optional[int] = None,
                      use_moe: bool = False) -> dict:
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    p: Dict[str, Any] = {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
        "ffn_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
    }
    if cfg.mla is not None:
        p["attn"] = L.init_mla(gen, cfg.d_model, cfg.n_heads, cfg.mla, dt,
                               device=device)
    else:
        p["attn"] = L.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd, dt,
            qkv_bias=cfg.qkv_bias, device=device,
        )
    if use_moe:
        p["moe"] = M.init_moe(gen, cfg.d_model, cfg.moe, dt, device=device)
    else:
        p["ffn"] = L.init_ffn(gen, cfg.d_model, d_ff or cfg.d_ff, dt, cfg.act,
                              device=device)
    return p


def _apply_dense_layer(
    cfg: ArchConfig, rt: Runtime, p, x, positions, *,
    kv_cache=None, cache_index=None,
):
    """Standard pre-norm decoder layer (GQA or MLA; FFN or MoE).
    Returns (x, new_kv_cache, aux_loss)."""
    h = L.rmsnorm_apply(p["attn_norm"], x, cfg.norm_eps)
    seq_sharded = rt.seq_shard_attention and kv_cache is None \
        and x.shape[1] > 1 and is_dtensor(h)
    if seq_sharded:
        # SP for attention (`repro`'s ``_constrain(h, (None, "model",
        # None))``): the query sequence over 'model', so archs whose head
        # count doesn't divide the model axis (smollm: 15 heads) don't
        # replicate the quadratic scores on every model shard; the batch
        # keeps its data sharding
        h = shard_on(h, 1, "model")
    if cfg.mla is not None:
        attn_out, new_kv = L.mla_apply(
            p["attn"], h, n_heads=cfg.n_heads, mla=cfg.mla,
            positions=positions, rope_theta=cfg.rope_theta,
            latent_cache=kv_cache, cache_index=cache_index,
        )
    else:
        attn_out, new_kv = L.attention_apply(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            rope_theta=cfg.rope_theta, kv_cache=kv_cache,
            cache_index=cache_index,
        )
    if seq_sharded:  # back on the residual's layout
        attn_out = like(attn_out, x)
    x = x + attn_out
    h = L.rmsnorm_apply(p["ffn_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        ffn_out, aux = M.moe_apply(
            p["moe"], h, moe=cfg.moe,
            capacity_factor=rt.moe_capacity_factor,
            dp_shards=rt.moe_dp_shards,
            ep_constraint=rt.moe_ep_constraint,
        )
    else:
        ffn_out = L.ffn_apply(p["ffn"], h, cfg.act)
    return x + ffn_out, new_kv, aux


def _empty_kv(cfg: ArchConfig, rt: Runtime, Bsz: int, s_max: int, device):
    hd = cfg.resolved_head_dim
    kw = dict(dtype=_cache_dtype(rt), device=device)
    if cfg.mla is not None:
        return (
            torch.zeros((Bsz, s_max, cfg.mla.kv_lora_rank), **kw),
            torch.zeros((Bsz, s_max, cfg.mla.qk_rope_head_dim), **kw),
        )
    return (
        torch.zeros((Bsz, s_max, cfg.n_kv_heads, hd), **kw),
        torch.zeros((Bsz, s_max, cfg.n_kv_heads, hd), **kw),
    )


# ===========================================================================
# Family: dense (smollm, tinyllama, qwen2, llama3) and moe (deepseek, llama4)
# ===========================================================================


def _moe_layout(cfg: ArchConfig):
    """Which layers are MoE. Returns (is_moe: list[bool])."""
    if cfg.moe is None:
        return [False] * cfg.n_layers
    out = []
    for i in range(cfg.n_layers):
        if i < cfg.moe.first_dense_layers:
            out.append(False)
        else:
            out.append((i - cfg.moe.first_dense_layers)
                       % cfg.moe.moe_layer_step == 0)
    return out


def _decoder_units(cfg: ArchConfig):
    """(n_lead, unit, n_units, unit_layout): leading dense layers, then
    n_units repeats of a unit of `unit` layers covering the MoE interleave."""
    layout = _moe_layout(cfg)
    n_lead = cfg.moe.first_dense_layers if cfg.moe else 0
    body_layout = layout[n_lead:]
    unit = cfg.moe.moe_layer_step if cfg.moe else 1
    assert len(body_layout) % unit == 0, (cfg.name, len(body_layout), unit)
    return n_lead, unit, len(body_layout) // unit, body_layout[:unit]


class DecoderLM(_Family):
    """Decoder-only LM (`repro`'s `build_decoder_lm`): dense, MoE-interleaved
    and MLA. `repro` scans each unit position over its stacked layers in
    turn, so all ``pos0`` layers of every unit run before any ``pos1``
    layer: for llama4-maverick (``moe_layer_step=2``) the 24 MoE layers,
    then the 24 dense ones. The port keeps that order."""

    @staticmethod
    def init_tree(cfg, gen, device):
        n_lead, unit, n_units, unit_layout = _decoder_units(cfg)
        dt = _dtype(cfg)
        lead_dff = (cfg.moe.dense_d_ff or cfg.d_ff) if cfg.moe else cfg.d_ff
        p = {
            "tok": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device=device),
            "final_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
            "lead": [
                _drawn(_init_dense_layer(cfg, gen, device, d_ff=lead_dff))
                for _ in range(n_lead)
            ],
            "units": {
                f"pos{j}": _stack_init(
                    lambda j=j: _init_dense_layer(
                        cfg, gen, device, d_ff=lead_dff,
                        use_moe=unit_layout[j],
                    ),
                    n_units,
                )
                for j in range(unit)
            },
        }
        if not cfg.tie_embeddings:
            p["unembed"] = {"unembed": L._dense_init(
                gen, (cfg.vocab_size, cfg.d_model), dt, device=device)}
        return p

    def _embed(self, tokens, rt: Runtime):
        return L.embedding_apply(
            self.tok, tokens, backend=rt.embed_backend,
            window=rt.embed_window, block_rows=rt.embed_block_rows,
        )

    def _head(self):
        return self.tok if self.cfg.tie_embeddings else self.unembed

    def _run_stack(self, x, positions, rt, cache=None, cache_index=None):
        cfg = self.cfg
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_lead = []
        for i, lp in enumerate(self.lead):
            kv = cache["lead"][i] if cache is not None else None
            x, nkv, aux = _apply_dense_layer(
                cfg, rt, lp, x, positions, kv_cache=kv,
                cache_index=cache_index)
            aux_total = aux_total + aux
            new_lead.append(nkv)
        new_units = {}
        for name in self.units.keys():
            kvs = []
            for u, lp in enumerate(self.units[name]):
                kv = cache["units"][name][u] if cache is not None else None
                x, nkv, aux = _layer(rt, functools.partial(
                    _apply_dense_layer, cfg, rt, lp, kv_cache=kv,
                    cache_index=cache_index), x, positions)
                aux_total = aux_total + aux
                kvs.append(nkv)
            new_units[name] = kvs
        new_cache = ({"lead": new_lead, "units": new_units}
                     if cache is not None else None)
        return x, new_cache, aux_total

    def forward(self, batch, rt: Runtime):
        tokens = batch["tokens"]
        x = self._embed(tokens, rt)
        positions = _positions(0, tokens.shape[1], x.device)
        x, _, aux = self._run_stack(x, positions, rt)
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self._head(), x), aux

    @staticmethod
    def empty_cache(cfg, Bsz, s_max, rt, device):
        n_lead, unit, n_units, _ = _decoder_units(cfg)
        return {
            "lead": [_empty_kv(cfg, rt, Bsz, s_max, device)
                     for _ in range(n_lead)],
            "units": {
                f"pos{j}": [_empty_kv(cfg, rt, Bsz, s_max, device)
                            for _ in range(n_units)]
                for j in range(unit)
            },
            "index": 0,
        }

    def init_cache(self, Bsz, s_max, rt, device=None):
        return self.empty_cache(self.cfg, Bsz, s_max, rt,
                                device or self.device)

    def decode_step(self, tokens, cache, rt: Runtime):
        """tokens: (B, S_step). Works for prefill (S_step=S) and decode (=1)."""
        index = cache["index"]
        x = self._embed(tokens, rt)
        positions = _positions(index, tokens.shape[1], x.device)
        x, new_cache, _ = self._run_stack(
            x, positions, rt,
            cache={"lead": cache["lead"], "units": cache["units"]},
            cache_index=index,
        )
        new_cache["index"] = index + tokens.shape[1]
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self._head(), x[:, -1:]), new_cache


def build_decoder_lm(cfg: ArchConfig):
    return _builder(DecoderLM, cfg)


# ===========================================================================
# Family: hybrid (zamba2 — Mamba2 stack with a shared attention block)
# ===========================================================================


def _zamba2_units(cfg: ArchConfig):
    every = cfg.ssm.shared_attn_every
    n_units = cfg.n_layers // every  # units of `every` mamba + 1 shared attn
    return every, n_units, cfg.n_layers - n_units * every


class Zamba2(_Family):
    """Mamba2 units, each followed by ONE shared transformer block (weights
    reused at every call site), then the trailing mamba layers."""

    @staticmethod
    def init_tree(cfg, gen, device):
        ssm = cfg.ssm
        every, n_units, n_tail = _zamba2_units(cfg)
        dt = _dtype(cfg)

        def mamba():
            return {
                "norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
                "mixer": S.init_mamba2(gen, cfg.d_model, ssm, dt,
                                       device=device),
            }

        return {
            "tok": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device=device),
            "final_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
            "mamba_units": _stack_init(lambda: _stack_init(mamba, every),
                                       n_units),
            "mamba_tail": _stack_init(mamba, n_tail) if n_tail else None,
            "shared": _init_dense_layer(cfg, gen, device),
        }

    def _mamba_layer(self, lp, state, x):
        h = L.rmsnorm_apply(lp["norm"], x, self.cfg.norm_eps)
        out, st = S.mamba2_apply(lp["mixer"], h, ssm=self.cfg.ssm,
                                 state=state)
        return x + out, st

    def _mamba_seq(self, x, layers, states, rt):
        new = []
        for i, lp in enumerate(layers):
            x, st = _layer(rt, functools.partial(
                self._mamba_layer, lp,
                states[i] if states is not None else None), x)
            new.append(st)
        return x, new

    def _run(self, x, positions, rt, cache=None, cache_index=None):
        new_cache: Dict[str, Any] = {"units": [], "shared_kv": [],
                                     "tail": None}
        for j, unit in enumerate(self.mamba_units):
            x, st = self._mamba_seq(
                x, unit, cache["units"][j] if cache is not None else None,
                rt)
            kv = cache["shared_kv"][j] if cache is not None else None
            x, nkv, _ = _apply_dense_layer(
                self.cfg, rt, self.shared, x, positions,
                kv_cache=kv, cache_index=cache_index,
            )
            new_cache["units"].append(st)
            new_cache["shared_kv"].append(nkv)
        if self.mamba_tail is not None:
            x, new_cache["tail"] = self._mamba_seq(
                x, self.mamba_tail,
                cache["tail"] if cache is not None else None, rt)
        return x, (new_cache if cache is not None else None)

    def forward(self, batch, rt: Runtime):
        tokens = batch["tokens"]
        x = self._embed(tokens, rt)
        x, _ = self._run(x, _positions(0, tokens.shape[1], x.device), rt)
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.tok, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    @staticmethod
    def empty_cache(cfg, Bsz, s_max, rt, device):
        every, n_units, n_tail = _zamba2_units(cfg)

        def state():
            return S.mamba2_init_state(Bsz, cfg.d_model, cfg.ssm,
                                       _dtype(cfg), device=device)

        return {
            "units": [[state() for _ in range(every)]
                      for _ in range(n_units)],
            "shared_kv": [_empty_kv(cfg, rt, Bsz, s_max, device)
                          for _ in range(n_units)],
            "tail": [state() for _ in range(n_tail)] if n_tail else None,
            "index": 0,
        }

    def init_cache(self, Bsz, s_max, rt, device=None):
        return self.empty_cache(self.cfg, Bsz, s_max, rt,
                                device or self.device)

    def decode_step(self, tokens, cache, rt: Runtime):
        index = cache["index"]
        x = self._embed(tokens, rt)
        x, new_cache = self._run(
            x, _positions(index, tokens.shape[1], x.device), rt,
            cache=cache, cache_index=index)
        new_cache["index"] = index + tokens.shape[1]
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.tok, x[:, -1:]), new_cache


def build_zamba2(cfg: ArchConfig):
    return _builder(Zamba2, cfg)


# ===========================================================================
# Family: ssm (xlstm — mLSTM stack with periodic sLSTM)
# ===========================================================================


def _xlstm_units(cfg: ArchConfig):
    every = cfg.xlstm.slstm_every
    assert cfg.n_layers % every == 0, (cfg.n_layers, every)
    return every, cfg.n_layers // every  # unit = (every-1) mLSTM + 1 sLSTM


class XLSTM(_Family):
    """Units of (every - 1) mLSTM blocks and one sLSTM block."""

    @staticmethod
    def init_tree(cfg, gen, device):
        xl = cfg.xlstm
        every, n_units = _xlstm_units(cfg)
        dt = _dtype(cfg)

        def mlstm():
            return {"norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
                    "cell": X.init_mlstm(gen, cfg.d_model, xl, dt,
                                         device=device)}

        def slstm():
            return {"norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
                    "cell": X.init_slstm(gen, cfg.d_model, cfg.n_heads, xl,
                                         dt, device=device)}

        return {
            "tok": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device=device),
            "final_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
            "mlstm": _stack_init(lambda: _stack_init(mlstm, every - 1),
                                 n_units),
            "slstm": _stack_init(slstm, n_units),
        }

    def _mlstm_layer(self, lp, state, x):
        cfg = self.cfg
        h = L.rmsnorm_apply(lp["norm"], x, cfg.norm_eps)
        out, st = X.mlstm_apply(lp["cell"], h, n_heads=cfg.n_heads,
                                chunk=cfg.xlstm.chunk, state=state)
        return x + out, st

    def _run(self, x, rt, cache=None):
        cfg = self.cfg
        m_new, s_new = [], []
        for j, (unit, sp) in enumerate(zip(self.mlstm, self.slstm)):
            states = []
            for i, lp in enumerate(unit):
                x, st = _layer(rt, functools.partial(
                    self._mlstm_layer, lp,
                    cache["mlstm"][j][i] if cache is not None else None), x)
                states.append(st)
            m_new.append(states)
            h = L.rmsnorm_apply(sp["norm"], x, cfg.norm_eps)
            out, st = X.slstm_apply(
                sp["cell"], h, n_heads=cfg.n_heads,
                state=cache["slstm"][j] if cache is not None else None)
            x = x + out
            s_new.append(st)
        if cache is not None:
            return x, {"mlstm": m_new, "slstm": s_new}
        return x, None

    def forward(self, batch, rt: Runtime):
        x = self._embed(batch["tokens"], rt)
        x, _ = self._run(x, rt)
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.tok, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    @staticmethod
    def empty_cache(cfg, Bsz, s_max, rt, device):
        every, n_units = _xlstm_units(cfg)
        return {
            "mlstm": [[X.mlstm_init_state(Bsz, cfg.d_model, cfg.n_heads,
                                          cfg.xlstm, _dtype(cfg),
                                          device=device)
                       for _ in range(every - 1)] for _ in range(n_units)],
            "slstm": [X.slstm_init_state(Bsz, cfg.d_model, cfg.n_heads,
                                         device=device)
                      for _ in range(n_units)],
            "index": 0,
        }

    def init_cache(self, Bsz, s_max, rt, device=None):
        return self.empty_cache(self.cfg, Bsz, s_max, rt,
                                device or self.device)

    def decode_step(self, tokens, cache, rt: Runtime):
        x = self._embed(tokens, rt)
        x, new_cache = self._run(x, rt, cache=cache)
        new_cache["index"] = cache["index"] + tokens.shape[1]
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.tok, x[:, -1:]), new_cache


def build_xlstm(cfg: ArchConfig):
    return _builder(XLSTM, cfg)


# ===========================================================================
# Family: audio (whisper — encoder-decoder, stub conv frontend)
# ===========================================================================


class Whisper(_Family):
    """Encoder-decoder; the encoder takes precomputed frame embeddings (a
    stub frontend, as in `repro`). `decode_step` needs ``cache["enc_out"]``
    (`encode`'s output), which the serving layer sets."""

    @staticmethod
    def init_tree(cfg, gen, device):
        dt = _dtype(cfg)
        hd = cfg.resolved_head_dim

        def attention():
            return L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, hd, dt, qkv_bias=True,
                                    device=device)

        def norm():
            return L.init_layernorm(cfg.d_model, dt, device=device)

        def ffn():
            return L.init_ffn(gen, cfg.d_model, cfg.d_ff, dt, act="gelu",
                              device=device)

        def enc_layer():
            return {"attn_norm": norm(), "attn": attention(),
                    "ffn_norm": norm(), "ffn": ffn()}

        def dec_layer():
            return {"self_norm": norm(), "self_attn": attention(),
                    "cross_norm": norm(), "cross_attn": attention(),
                    "ffn_norm": norm(), "ffn": ffn()}

        return {
            "tok": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device=device),
            "enc_pos": L._normal(gen, (1, 4096, cfg.d_model), device, 0.01,
                                 dt),
            "dec_pos": L._normal(gen, (1, 4096, cfg.d_model), device, 0.01,
                                 dt),
            "enc": _stack_init(enc_layer, cfg.encdec.n_encoder_layers),
            "dec": _stack_init(dec_layer, cfg.n_layers),
            "enc_norm": norm(),
            "final_norm": norm(),
        }

    @staticmethod
    def _pos_slice(table, start, length):
        # positional rows modulo the table length (long inputs wrap)
        idx = (start + torch.arange(length, device=table.device)) \
            % table.shape[1]
        return table[0, idx]

    def encode(self, enc_input, rt: Runtime):
        """enc_input: (B, S_enc, D) — precomputed frame embeddings."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        Se = enc_input.shape[1]
        x = enc_input.to(device=self.device, dtype=_dtype(cfg)) \
            + self._pos_slice(self.enc_pos, 0, Se)
        positions = _positions(0, Se, x.device)
        full = torch.ones((1, 1, Se, Se), dtype=torch.bool, device=x.device)
        for lp in self.enc:
            x = _layer(rt, functools.partial(self._enc_layer, lp, positions,
                                             full), x)
        return L.layernorm_apply(self.enc_norm, x, cfg.norm_eps)

    def _enc_layer(self, lp, positions, full, x):
        cfg = self.cfg
        h = L.layernorm_apply(lp["attn_norm"], x, cfg.norm_eps)
        out, _ = L.attention_apply(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            use_rope=False, mask=full,
        )
        x = x + out
        h = L.layernorm_apply(lp["ffn_norm"], x, cfg.norm_eps)
        return x + L.ffn_apply(lp["ffn"], h, "gelu")

    def _dec_stack(self, x, positions, enc_out, rt, cache=None,
                   cache_index=None):
        cross_mask = torch.ones((1, 1, 1, enc_out.shape[1]),
                                dtype=torch.bool, device=x.device)
        new_kv = []
        for i, lp in enumerate(self.dec):
            x, nkv = _layer(rt, functools.partial(
                self._dec_layer, lp, positions, enc_out, cross_mask,
                cache[i] if cache is not None else None, cache_index), x)
            new_kv.append(nkv)
        return x, (new_kv if cache is not None else None)

    def _dec_layer(self, lp, positions, enc_out, cross_mask, kv,
                   cache_index, x):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        h = L.layernorm_apply(lp["self_norm"], x, cfg.norm_eps)
        out, nkv = L.attention_apply(
            lp["self_attn"], h, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=hd, positions=positions,
            use_rope=False, kv_cache=kv, cache_index=cache_index,
        )
        x = x + out
        h = L.layernorm_apply(lp["cross_norm"], x, cfg.norm_eps)
        ca = lp["cross_attn"]
        k = L.split_heads(L.mm(enc_out, ca["wk"]) + ca["bk"],
                          cfg.n_kv_heads, hd)
        v = L.split_heads(L.mm(enc_out, ca["wv"]) + ca["bv"],
                          cfg.n_kv_heads, hd)
        out, _ = L.attention_apply(
            ca, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=hd, positions=positions, use_rope=False,
            kv_override=(k, v), mask=cross_mask,
        )
        x = x + out
        h = L.layernorm_apply(lp["ffn_norm"], x, cfg.norm_eps)
        return x + L.ffn_apply(lp["ffn"], h, "gelu"), nkv

    def forward(self, batch, rt: Runtime):
        enc_out = self.encode(batch["enc_input"], rt)
        tokens = batch["tokens"]
        Sq = tokens.shape[1]
        x = self._embed(tokens, rt)
        x = x + self._pos_slice(self.dec_pos, 0, Sq)
        x, _ = self._dec_stack(x, _positions(0, Sq, x.device), enc_out, rt)
        x = L.layernorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.tok, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    @staticmethod
    def empty_cache(cfg, Bsz, s_max, rt, device):
        return {
            "self_kv": [_empty_kv(cfg, rt, Bsz, s_max, device)
                        for _ in range(cfg.n_layers)],
            "enc_out": None,  # filled by prefill (encoder run)
            "index": 0,
        }

    def init_cache(self, Bsz, s_max, rt, device=None):
        return self.empty_cache(self.cfg, Bsz, s_max, rt,
                                device or self.device)

    def decode_step(self, tokens, cache, rt: Runtime):
        """Requires cache['enc_out'] (B, Se, D) set by the serving layer."""
        Sq = tokens.shape[1]
        index = cache["index"]
        x = self._embed(tokens, rt)
        x = x + self._pos_slice(self.dec_pos, index, Sq)
        x, new_kv = self._dec_stack(
            x, _positions(index, Sq, x.device), cache["enc_out"], rt,
            cache=cache["self_kv"], cache_index=index,
        )
        x = L.layernorm_apply(self.final_norm, x, self.cfg.norm_eps)
        new_cache = dict(cache, self_kv=new_kv, index=index + Sq)
        return L.logits_apply(self.tok, x[:, -1:]), new_cache


def build_whisper(cfg: ArchConfig):
    init, forward, init_cache, decode_step = _builder(Whisper, cfg)

    def encode(p, enc_input, rt: Runtime):
        return p.encode(enc_input, rt)

    return init, forward, init_cache, decode_step, {"encode": encode}


# ===========================================================================
# Family: vlm (llama-3.2-vision — cross-attn image layers every k-th layer)
# ===========================================================================


def _vlm_units(cfg: ArchConfig):
    every = cfg.cross_attn.every
    assert cfg.n_layers % every == 0
    return every, cfg.n_layers // every  # unit = (every-1) self + 1 cross


class VLM(_Family):
    """Units of (every - 1) self-attention layers and one gated
    cross-attention layer over the image embeddings (a stub frontend);
    `decode_step` needs ``cache["image_embeds"]``."""

    @staticmethod
    def init_tree(cfg, gen, device):
        every, n_units = _vlm_units(cfg)
        dt = _dtype(cfg)
        hd = cfg.resolved_head_dim

        def cross_layer():
            return {
                "attn_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
                "xattn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, hd, dt,
                                          device=device),
                "gate_attn": torch.zeros((), dtype=dt, device=device),
                "ffn_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
                "ffn": L.init_ffn(gen, cfg.d_model, cfg.d_ff, dt, cfg.act,
                                  device=device),
                "gate_ffn": torch.zeros((), dtype=dt, device=device),
            }

        return {
            "tok": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                    device=device),
            "final_norm": L.init_rmsnorm(cfg.d_model, dt, device=device),
            "self_units": _stack_init(
                lambda: _stack_init(
                    lambda: _init_dense_layer(cfg, gen, device), every - 1),
                n_units),
            "cross": _stack_init(cross_layer, n_units),
            "unembed": {"unembed": L._dense_init(
                gen, (cfg.vocab_size, cfg.d_model), dt, device=device)},
        }

    def _cross_apply(self, lp, x, img_kv):
        cfg = self.cfg
        h = L.rmsnorm_apply(lp["attn_norm"], x, cfg.norm_eps)
        out, _ = L.attention_apply(
            lp["xattn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            positions=torch.zeros((1, x.shape[1]), dtype=torch.int32,
                                  device=x.device),
            use_rope=False, kv_override=img_kv,
            mask=torch.ones((1, 1, 1, img_kv[0].shape[1]), dtype=torch.bool,
                            device=x.device),
        )
        x = x + torch.tanh(lp["gate_attn"]) * out
        h = L.rmsnorm_apply(lp["ffn_norm"], x, cfg.norm_eps)
        return x + torch.tanh(lp["gate_ffn"]) * L.ffn_apply(lp["ffn"], h,
                                                            cfg.act)

    def _img_kv(self, lp, img_embeds):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        k = L.split_heads(L.mm(img_embeds, lp["xattn"]["wk"]),
                          cfg.n_kv_heads, hd)
        v = L.split_heads(L.mm(img_embeds, lp["xattn"]["wv"]),
                          cfg.n_kv_heads, hd)
        return k, v

    def _run(self, x, positions, img_embeds, rt, cache=None,
             cache_index=None):
        new_units = []
        for j, (unit, clp) in enumerate(zip(self.self_units, self.cross)):
            kvs = []
            for i, lp in enumerate(unit):
                x, nkv, _ = _layer(rt, functools.partial(
                    _apply_dense_layer, self.cfg, rt, lp,
                    kv_cache=cache["self_kv"][j][i] if cache is not None
                    else None,
                    cache_index=cache_index), x, positions)
                kvs.append(nkv)
            new_units.append(kvs)
            x = self._cross_apply(clp, x, self._img_kv(clp, img_embeds))
        return x, ({"self_kv": new_units} if cache is not None else None)

    def forward(self, batch, rt: Runtime):
        tokens = batch["tokens"]
        x = self._embed(tokens, rt)
        img = batch["image_embeds"].to(device=x.device, dtype=x.dtype)
        x, _ = self._run(x, _positions(0, tokens.shape[1], x.device), img,
                         rt)
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.unembed, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    @staticmethod
    def empty_cache(cfg, Bsz, s_max, rt, device):
        every, n_units = _vlm_units(cfg)
        return {
            "self_kv": [[_empty_kv(cfg, rt, Bsz, s_max, device)
                         for _ in range(every - 1)] for _ in range(n_units)],
            "image_embeds": None,  # set by the serving layer
            "index": 0,
        }

    def init_cache(self, Bsz, s_max, rt, device=None):
        return self.empty_cache(self.cfg, Bsz, s_max, rt,
                                device or self.device)

    def decode_step(self, tokens, cache, rt: Runtime):
        index = cache["index"]
        x = self._embed(tokens, rt)
        img = cache["image_embeds"].to(device=x.device, dtype=x.dtype)
        x, nc = self._run(
            x, _positions(index, tokens.shape[1], x.device), img, rt,
            cache={"self_kv": cache["self_kv"]}, cache_index=index,
        )
        new_cache = dict(cache, self_kv=nc["self_kv"],
                         index=index + tokens.shape[1])
        x = L.rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        return L.logits_apply(self.unembed, x[:, -1:]), new_cache


def build_vlm(cfg: ArchConfig):
    return _builder(VLM, cfg)


FAMILY_CLASSES = {
    "dense": DecoderLM, "moe": DecoderLM, "hybrid": Zamba2, "ssm": XLSTM,
    "audio": Whisper, "vlm": VLM,
}
