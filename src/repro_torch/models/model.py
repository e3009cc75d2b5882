"""Unified model interface (port of `repro.models.model`): build_model(cfg)
-> Model with init / forward / cache / decode, the training loss, the
parameter count and a seeded input batch."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import resolve_device
from .transformer import (
    Runtime,
    build_decoder_lm,
    build_vlm,
    build_whisper,
    build_xlstm,
    build_zamba2,
)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]  # (generator, device, place) -> the module
    forward: Callable[..., Any]  # (params, batch, rt) -> (logits, aux)
    init_cache: Callable[..., Any]  # (batch, max_len, rt, device) -> cache
    decode_step: Callable[..., Any]  # (params, tokens, cache, rt) -> (logits, cache)
    extras: Dict[str, Callable] = dataclasses.field(default_factory=dict)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid", "ssm"):
        if cfg.family == "hybrid":
            fns = build_zamba2(cfg)
        elif cfg.family == "ssm":
            fns = build_xlstm(cfg)
        elif cfg.family == "audio":
            *fns, extras = build_whisper(cfg)
            return Model(cfg, *fns, extras=extras)
        elif cfg.family == "vlm":
            fns = build_vlm(cfg)
        else:
            fns = build_decoder_lm(cfg)
        return Model(cfg, *fns)
    raise ValueError(f"unknown family {cfg.family!r} for arch {cfg.name}")


def lm_loss(
    model: Model, params, batch: Dict[str, torch.Tensor], rt: Runtime,
    aux_weight: float = 0.01,
) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux loss), differentiable in the
    parameters (`train.loop` takes its gradients with `torch.autograd`).
    batch['tokens'] (B, S); optional batch['loss_mask'] (B, S)."""
    logits, aux = model.forward(params, batch, rt)  # (B, S, V) f32
    tokens = batch["tokens"].to(logits.device)
    targets = tokens[:, 1:].to(torch.int64)
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].to(device=logits.device, dtype=torch.float32)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + aux_weight * aux


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())


def make_input_batch(
    cfg: ArchConfig, batch_size: int, seq_len: int,
    generator: Optional[torch.Generator] = None, device=None,
) -> Dict[str, torch.Tensor]:
    """A seeded random batch on `device` (default the card; the generator
    must live there; default: seed 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                                generator=generator, device=device,
                                dtype=torch.int32)
    }
    if cfg.family == "audio":
        batch["enc_input"] = torch.randn(
            (batch_size, seq_len, cfg.d_model), generator=generator,
            device=device) * 0.02
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (batch_size, cfg.cross_attn.n_image_tokens, cfg.d_model),
            generator=generator, device=device) * 0.02
    return batch


def param_shapes(cfg: ArchConfig):
    """The family module of `cfg` with its parameters on the ``meta``
    device (shapes and dtypes, nothing allocated): the port's
    ``jax.eval_shape(model.init, key)``."""
    from .transformer import FAMILY_CLASSES

    cls = FAMILY_CLASSES[cfg.family]
    return cls(cfg, cls.init_tree(cfg, torch.Generator(),
                                  torch.device("meta")))


def cache_shapes(cfg: ArchConfig, batch_size: int, s_max: int,
                 rt: Runtime):
    """`cfg`'s decode cache on the ``meta`` device (shapes and dtypes)."""
    from .transformer import FAMILY_CLASSES

    return FAMILY_CLASSES[cfg.family].empty_cache(
        cfg, batch_size, s_max, rt, torch.device("meta"))


def input_specs(
    cfg: ArchConfig, batch_size: int, seq_len: int
) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input on the ``meta`` device (shape and
    dtype, no storage): the no-allocation batch `repro` builds from
    ``jax.ShapeDtypeStruct``."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {"tokens": spec((batch_size, seq_len), torch.int32)}
    if cfg.family == "audio":
        specs["enc_input"] = spec((batch_size, seq_len, cfg.d_model),
                                  torch.float32)
    if cfg.family == "vlm":
        specs["image_embeds"] = spec(
            (batch_size, cfg.cross_attn.n_image_tokens, cfg.d_model),
            torch.float32)
    return specs
