"""Training step: loss -> grads -> clip -> optimizer, with optional
gradient accumulation (microbatching) and optional int8 gradient
compression.  The port of `repro.train.train_step`.

The step keeps the reference's signature, `train_step(params,
opt_state, batch) -> (params, opt_state, metrics)`: the parameters are
the model's own tensors (they require gradients), the gradients come
from `torch.autograd.grad` of `LM.train_loss`, and the optimizer writes
the new values into the same tensors in place.

On one device every tensor is a plain one.  Over a training mesh
(`launch.mesh.init_train_mesh`, one process a card) the step is the
reference's sharded step: each parameter is a DTensor placed by its
spec (`LM(..., mesh=)`, or `init_train_state(..., mesh=)` placing a
model built whole), the optimizer state inherits its parameter's
placements (ZeRO: `opt_state_specs`), each rank hands the step its own
rows of the global batch (`rank_rows`, `data.pipeline.make_batch_rows`),
which the step places by `batch_spec`, and the collectives are DTensor's:
gradients reduce-scattered to their parameter's shards, the clip norm
summed over the whole mesh.  Every family trains over a mesh: the
MoE's experts and the SSD's heads over "model", image embeddings,
frames and labels placed over the batch axes with the tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from ..models.lm import LM
from ..sharding.rules import (P, batch_spec, even_placements, local_range,
                              mesh_placements, on_mesh)
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


def place_batch(batch: dict, mesh, shardable: bool = True) -> dict:
    """This rank's rows of the global batch as DTensors placed by
    `batch_spec` (a training step's, a prefill's or a decode step's
    inputs: tokens, frames, labels, image embeddings); with
    `shardable` False (a batch the batch axes do not divide,
    `rules.batch_shardable`) every rank holds the whole batch,
    replicated.  DTensors pass as they are."""
    def place(x):
        if isinstance(x, DTensor):
            return x
        pl = mesh_placements(batch_spec(x.dim() - 1) if shardable else P(),
                             mesh)
        return DTensor.from_local(x, mesh, pl, run_check=False)
    return {k: place(x) for k, x in batch.items()}


def rank_rows(mesh, global_batch: int) -> tuple[int, int]:
    """(start, stop): the rows of a `global_batch`-row batch that this
    rank of `mesh` holds under `batch_spec` (ranks that share the batch
    axes' coordinates hold the same rows)."""
    return local_range(mesh, mesh_placements(batch_spec(1), mesh), 0,
                       global_batch)


def _microbatch(x, mb: int, i: int):
    """Microbatch `i` of `mb` of a batch leaf.  A DTensor whose local
    rows `mb` divides splits them, so each microbatch keeps the batch's
    placements with no collective: its rows are another partition of
    the global batch than the single-device split's, and the mean over
    all microbatches is the same.  Where it does not (fewer rows a rank
    than microbatches), microbatch `i` is the reference's: global rows
    `i * n` to `(i + 1) * n`, gathered and placed as the batch is on
    the mesh dims that divide `n` rows, replicated over the others
    (`even_placements`)."""
    if x.shape[0] % mb:
        raise ValueError(f"{mb} microbatches do not divide the batch's "
                         f"{x.shape[0]} rows")
    n = x.shape[0] // mb
    if isinstance(x, DTensor):
        local = x.to_local()
        if local.shape[0] % mb:
            part = x[i * n:(i + 1) * n]
            return part.redistribute(x.device_mesh, even_placements(
                x.placements, part.shape, x.device_mesh))
        part = local.reshape((mb, local.shape[0] // mb)
                             + tuple(local.shape[1:]))[i]
        return DTensor.from_local(part, x.device_mesh, x.placements,
                                  run_check=False)
    return x.reshape((mb, n) + tuple(x.shape[1:]))[i]


def _like_param(g, p):
    """A gradient in its parameter's placements (a reduce-scatter from
    a partial sum, a local slice from a replica)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(x):
    """A metric as a plain tensor, the same on every rank."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(model: LM, tcfg: TrainConfig, mesh=None
                    ) -> tuple[Callable, Callable]:
    """(train_step, init_opt) for `model` under `tcfg`: the optimizer is
    the model config's (`cfg.optimizer`).  With `mesh` (a training
    mesh; the model's parameters placed on it, `init_train_state`) the
    step takes each rank's rows of the batch and runs sharded."""
    init_opt, update_opt = make_optimizer(model.cfg.optimizer, tcfg.opt)

    def loss_and_grads(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = model.train_loss(batch, params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A leaf the loss never reads (the audio encoder's token table)
        # gets a zero gradient, as under jax.grad.
        grads = [torch.zeros_like(p) if g is None else _like_param(g, p)
                 for p, g in zip(leaves, grads)]
        return loss.detach(), metrics, _unflatten_like(params, grads)

    def step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb > 1:
            # split the batch along its batch axis; accumulate grads
            # in float32
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = 0.0
            for i in range(mb):
                part = {k: _microbatch(x, mb, i) for k, x in batch.items()}
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
        metrics = {k: _plain(v.detach()) if isinstance(v, torch.Tensor)
                   else v for k, v in metrics.items()}
        metrics.update(loss=_plain(loss), grad_norm=_plain(gnorm))
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        if mesh is not None:
            if model.mesh is not mesh:
                raise ValueError("the model's parameters are not on the "
                                 "step's mesh: init_train_state(model, "
                                 "tcfg, mesh) places them")
            batch = place_batch(batch, mesh)
        with on_mesh(mesh):
            return step(params, opt_state, batch)

    return train_step, init_opt


def init_train_state(model: LM, tcfg: TrainConfig, mesh=None):
    """(params, opt_state): the model's parameter tree (drawn when the
    model was built) and a fresh optimizer state for it.  With `mesh`
    the parameters are first placed on it (`LM.shard`; a model built
    with `mesh` is already), and each moment takes its parameter's
    placements."""
    if mesh is not None:
        model.shard(mesh)
    params = model.params
    init_opt, _ = make_optimizer(model.cfg.optimizer, tcfg.opt)
    return params, init_opt(tcfg.opt, params)


def opt_state_specs(param_specs: dict, opt_name: str) -> dict:
    """Optimizer-state PartitionSpecs congruent with the state trees of
    `optimizer.adam_init` and `adafactor_init` (ZeRO: the moments take
    their parameter's spec; Adafactor's factored state drops one dim of
    it)."""
    if opt_name == "adam":
        return {"m": param_specs, "v": param_specs, "step": P()}

    def factored(node):
        if isinstance(node, dict):
            return {k: factored(v) for k, v in node.items()}
        parts = tuple(node)
        if len(parts) >= 2:
            return {"vr": P(*parts[:-1]), "vc": P(*parts[:-2], parts[-1])}
        return {"v": P(*parts)}

    return {"v": factored(param_specs), "step": P()}
