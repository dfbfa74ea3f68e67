"""Optimizers on torch tensors: AdamW and Adafactor (factored second
moment for the 340B/1T-class configs whose full Adam state does not
fit a card).  The port of `repro.train.optimizer`.

Parameters, gradients and state are trees of nested dicts with tensor
leaves; the state is congruent with the parameters.  Unlike the
reference, whose arrays are immutable, an update writes the new
parameters and moments into the given tensors in place (at full width
that saves a copy of each: 3.0 GB of parameters and 6.0 GB of Adam
moments for Qwen3-0.6B's 751.6M parameters) and returns the same
trees.  The arithmetic is the reference's, in float32, with the bias
corrections `1 - b ** step` formed as float32 tensors as the
reference's traced step does.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adam"            # adam | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: str = "float32"


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mdt(cfg: OptConfig) -> torch.dtype:
    return _MOMENT_DTYPES[cfg.moment_dtype]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (nested dicts), with the nodes of
    `rest` at the same keys: a node of `rest` may be a whole subtree
    where `tree` has a leaf (Adafactor's factored state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the reference's `jax.tree.leaves`
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to `cfg.lr` at float32 `step`."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adam_init(cfg: OptConfig, params: dict) -> dict:
    mdt = _mdt(cfg)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


@torch.no_grad()
def adam_update(cfg: OptConfig, params: dict, grads: dict, state: dict):
    """One AdamW step, written into `params` and the moments in place.
    Returns (params, new state)."""
    step = state["step"] + 1
    t = step.float()
    lr = schedule(cfg, t)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t

    def upd(p, g, m, v):
        g = g.float()
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored v, no first moment.
# ---------------------------------------------------------------------------

def adafactor_init(cfg: OptConfig, params: dict) -> dict:
    def factored(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"v": tree_map(factored, params), "step": step}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params: dict, grads: dict, state: dict):
    """One Adafactor step (update clipping at RMS 1, decoupled weight
    decay), written into `params` and the factored moments in place.
    Returns (params, new state)."""
    step = state["step"] + 1
    t = step.float()
    lr = schedule(cfg, t)
    decay = 1.0 - (t + 1.0) ** -0.8

    def upd(p, g, v):
        g = g.float()
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr = decay * v["vr"] + (1 - decay) * g2.mean(dim=-1)
            vc = decay * v["vc"] + (1 - decay) * g2.mean(dim=-2)
            denom = (vr[..., :, None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(dim=-1, keepdim=True)
                                       [..., None], 1e-30))
            update = g * torch.rsqrt(denom + 1e-30)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vv = decay * v["v"] + (1 - decay) * g2
            update = g * torch.rsqrt(vv + 1e-30)
            v["v"].copy_(vv)
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp_min(rms, 1.0)
        p.copy_(p.float() - lr * update
                - lr * cfg.weight_decay * p.float())

    tree_map(upd, params, grads, state["v"])
    return params, {"v": state["v"], "step": step}


def make_optimizer(name: str, cfg: OptConfig):
    """(init, update) of optimizer `name`: "adam" or "adafactor"."""
    if name == "adam":
        return adam_init, adam_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise KeyError(name)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm <= max_norm, the norm before)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm
