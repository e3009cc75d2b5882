"""Step functions (port of `repro.train.steps`): one training update, the
prefill pass and one decode step over a `models.Model`."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from repro_torch.models import Model, lm_loss
from repro_torch.models.transformer import Runtime
from repro_torch.optim.optimizer import OptConfig, OptState, adamw_update
from repro_torch.sharding.dtensor import holds_dtensors, replication

from .loop import value_and_grad


@contextlib.contextmanager
def _serving(params):
    """``torch.inference_mode`` on one device. On DTensor parameters (a
    process mesh) ``torch.no_grad``, DTensor refusing in-place ops (the
    cache writes) under inference mode, and plain tensors meet DTensors as
    replicated values."""
    if not holds_dtensors(params):
        with torch.inference_mode():
            yield
        return
    with torch.no_grad(), replication(params):
        yield


def make_train_step(model: Model, opt_cfg: OptConfig, rt: Runtime):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and the state are updated in place."""

    def train_step(params, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        loss, grads = value_and_grad(
            lambda p: lm_loss(model, p, batch, rt), params)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, params, grads, opt_state
        )
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model: Model, rt: Runtime):
    """(params, batch) -> last-position logits (the inference prefill
    pass)."""

    def prefill_step(params, batch):
        with _serving(params):
            logits, _ = model.forward(params, batch, rt)
            return logits[:, -1]

    return prefill_step


def make_serve_step(model: Model, rt: Runtime):
    """(params, tokens, cache) -> (logits, cache): one decode step with a
    KV/state cache of the cell's seq_len."""

    def serve_step(params, tokens, cache):
        with _serving(params):
            return model.decode_step(params, tokens, cache, rt)

    return serve_step
