"""Training step: loss -> grads -> clip -> optimizer, with optional
gradient accumulation (microbatching) and optional int8 gradient
compression.  The port of `repro.train.train_step`.

The step keeps the reference's signature, `train_step(params,
opt_state, batch) -> (params, opt_state, metrics)`, on one device: the
parameters are the model's own tensors (they require gradients), the
gradients come from `torch.autograd.grad` of `LM.train_loss`, and the
optimizer writes the new values into the same tensors in place.  The
reference's `opt_state_specs` (PartitionSpecs for sharding the
optimizer state) waits for multi-GPU work (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.lm import LM
from .optimizer import (OptConfig, clip_by_global_norm, make_optimizer,
                        tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # gradient accumulation steps
    compress_grads: bool = False   # int8-scale compression round trip


def _compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """Simulated int8 gradient compression (the value-faithful round
    trip the reference applies before a cross-pod reduction)."""
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _unflatten_like(tree, leaves: list):
    """A tree shaped like `tree` (sorted-key leaf order) holding
    `leaves`."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        return next(it)

    return take(tree)


def make_train_step(model: LM, tcfg: TrainConfig) -> tuple[Callable,
                                                          Callable]:
    """(train_step, init_opt) for `model` under `tcfg`: the optimizer is
    the model config's (`cfg.optimizer`)."""
    init_opt, update_opt = make_optimizer(model.cfg.optimizer, tcfg.opt)

    def loss_and_grads(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = model.train_loss(batch, params)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, _unflatten_like(params, grads)

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb > 1:
            # split the batch along its batch axis; accumulate grads
            # in float32
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(mb):
                part = {k: x.reshape((mb, x.shape[0] // mb)
                                     + tuple(x.shape[1:]))[i]
                        for k, x in batch.items()}
                loss_i, metrics, g = loss_and_grads(params, part)
                grads = tree_map(torch.add, grads, g)
                loss = loss + loss_i
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
        else:
            loss, metrics, grads = loss_and_grads(params, batch)

        if tcfg.compress_grads:
            grads = tree_map(_compress_decompress, grads)
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.grad_clip)
        params, opt_state = update_opt(tcfg.opt, params, grads, opt_state)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics.update(loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step, init_opt


def init_train_state(model: LM, tcfg: TrainConfig):
    """(params, opt_state): the model's parameter tree (drawn when the
    model was built) and a fresh optimizer state for it."""
    params = model.params
    init_opt, _ = make_optimizer(model.cfg.optimizer, tcfg.opt)
    return params, init_opt(tcfg.opt, params)
