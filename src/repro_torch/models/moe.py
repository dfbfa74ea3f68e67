"""Mixture-of-Experts (dropping, capacity-bounded) on torch: the port of
`repro.models.moe`.

The reference's gather/scatter formulation, with no (T, E, C) one-hot
dispatch tensor:

  1. router top-k per token on float32 probabilities;
  2. tokens ranked within their expert by a stable sort of the flat
     (token, slot) assignments; a rank at or past the capacity is
     dropped (capacity = tokens * k / E * capacity_factor, per group;
     the group is the batch row, as in the reference);
  3. gather (E, C, D) expert inputs, padded slots reading a zero row;
  4. the expert products, batched over experts (`torch.bmm`; the
     reference computes them in plain `jnp.einsum`, outside any Pallas
     kernel);
  5. scatter-add back with the router weights (`index_add`, whose float
     sum order differs from the reference's `.at[].add`).

The reference `vmap`s step 2-5 over groups; here the groups are a
leading batch axis and the expert products take every group's slots at
once.  The Switch-style auxiliary load-balance loss is returned for
training.  Expert weights are cast to the compute type at every call,
as in the reference (at Jamba's width that is 1.9 GB of transient
memory per bf16 weight).

Over a training mesh the reference's expert parallelism: the groups
(batch rows) are sharded over ("pod", "data") with the capacity per
row, the experts over "model", and each model rank gathers, computes
and scatters only its own experts' slots, on local tensors
(`local_map`).  Its output is a partial sum over "model", which the
constraint to the residual stream's sequence shards (`ACT_TOKENS_SEQ`)
reduce-scatters.  The load-balance loss is
a product of two means over all groups, so both are reduced over the
mesh before the product.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..sharding.rules import (ACT_GROUPS, ACT_TOKENS_SEQ, P, constrain,
                              fsdp_gather, local_range, spec, weight_product,
                              weights_stay)
from .layers import _activate, dense_init, dtype_of


def moe_init(gen: torch.Generator, cfg: ArchConfig, lead: tuple = (),
             device=None) -> dict:
    """Router and expert weights; `lead` prepends stacking dims (the
    LM's n_periods) to every leaf."""
    pdt = dtype_of(cfg.param_dtype)
    dev = gen.device if device is None else device
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    params = {
        "router": dense_init(gen, (*lead, d, e), pdt, device=dev),
        "w_up": dense_init(gen, (*lead, e, d, f), pdt, device=dev),
        "w_down": dense_init(gen, (*lead, e, f, d), pdt,
                             scale=1.0 / math.sqrt(f * 2 * cfg.n_layers),
                             device=dev),
    }
    if cfg.activation in ("swiglu", "geglu"):
        params["w_gate"] = dense_init(gen, (*lead, e, d, f), pdt, device=dev)
    return params


def moe_specs(cfg: ArchConfig) -> dict:
    """`moe_init`'s specs: experts over "model" (EP), FSDP on d_model."""
    specs = {"router": spec("embed", None),
             "w_up": spec("experts", "embed", "expert_mlp"),
             "w_down": spec("experts", "expert_mlp", "embed")}
    if cfg.activation in ("swiglu", "geglu"):
        specs["w_gate"] = spec("experts", "embed", "expert_mlp")
    return specs


def _capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.experts_per_token / cfg.n_experts
            * cfg.capacity_factor)
    return max(c, 1)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the `k` largest entries of the last axis,
    ties to the lower index (as `jax.lax.top_k`; `torch.topk` does not
    promise an order among equals): a stable descending sort."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(params: dict, cfg: ArchConfig, x: torch.Tensor, logits=None):
    """Router of `x` (G, T, D): (probs (G, T, E) float32, gate weights
    (G, T, k) renormalised over the k picks, expert indices (G, T, k)).
    `logits` (G, T, E), when given, are the router product already
    taken (in the compute type)."""
    cdt = dtype_of(cfg.compute_dtype)
    if logits is None:
        logits = x @ params["router"].to(cdt)
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = top_k(probs, cfg.experts_per_token)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_i


def dispatch(gate_i: torch.Tensor, gate_w: torch.Tensor, n_experts: int,
             cap: int):
    """Each group's (E, C) slot table: the token in each slot (T, the
    padding row, where empty) and its router weight (0 where empty).
    gate_i, gate_w: (G, T, k).  Assignments are ranked within their
    expert in (token, slot) order; ranks at or past `cap` are dropped,
    not clamped onto the last slot.  Returns (idx (G, E, C) int64,
    w (G, E, C) float32)."""
    g, t, k = gate_i.shape
    flat_e = gate_i.reshape(g, t * k)
    flat_w = gate_w.reshape(g, t * k)
    flat_tok = torch.arange(t, device=gate_i.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_w = torch.gather(flat_w, 1, order)
    counts = torch.zeros((g, n_experts), dtype=torch.int64,
                         device=gate_i.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(t * k, device=gate_i.device) \
        - torch.gather(offsets, 1, sorted_e)
    # Kept assignments go to slot (e, pos); dropped ones to one spare
    # column past the table, cut off below.
    slot = torch.where(pos < cap, sorted_e * cap + pos, n_experts * cap)
    idx = torch.full((g, n_experts * cap + 1), t, dtype=torch.int64,
                     device=gate_i.device).scatter(1, slot, flat_tok[order])
    w = torch.zeros((g, n_experts * cap + 1), dtype=torch.float32,
                    device=gate_i.device).scatter(1, slot, sorted_w)
    return (idx[:, :-1].reshape(g, n_experts, cap),
            w[:, :-1].reshape(g, n_experts, cap))


def _moe_groups(x: torch.Tensor, router: torch.Tensor, w_up: torch.Tensor,
               w_gate, w_down: torch.Tensor, *, cfg: ArchConfig,
               experts: tuple[int, int], n_groups: int,
               cols: tuple[int, int] | None = None, activate=None,
               logits=None):
    """`moe_apply` on plain tensors: x (G, T, D) holds `G` of the
    batch's `n_groups` groups, and the expert weights hold experts
    [`experts`) of the expert axis.  Every group is routed over all
    experts; only the held experts' slots are gathered, computed and
    scattered back, so `out` (G, T, D) sums those experts' outputs
    alone.  Returns (out, mean router probability (E,), assignment
    fraction (E,)): both are this call's share of the means over all
    `n_groups` groups, so summing them over the calls that together
    hold the batch gives the Switch statistics.

    With `cols` the expert weights hold d_model columns [`cols`) only
    (w_up and w_gate those rows, w_down those columns): the up products
    read those columns of the slots' inputs, `activate(u, gate)` sums
    their partial products over the ranks that hold the other columns
    and applies the activation, and `out` (G, T, cols) is those columns
    of the output.  `logits`: the router's (`route`)."""
    cdt = dtype_of(cfg.compute_dtype)
    g, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    e0, e1 = experts
    cap = _capacity(cfg, t)
    probs, gate_w, gate_i = route({"router": router}, cfg, x, logits)

    # Switch aux loss: mean prob x mean assignment fraction per expert.
    me = probs.sum(dim=(0, 1)) / (n_groups * t)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add(
        0, gate_i.reshape(-1),
        torch.full((g * t * k,), 1.0 / (n_groups * t * k), device=x.device))

    idx, w = dispatch(gate_i, gate_w, e, cap)
    idx, w = idx[:, e0:e1], w[:, e0:e1]                      # held experts
    el = e1 - e0
    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)    # (G, T+1, D)
    x_ec = torch.gather(x_pad, 1, idx.reshape(g, el * cap, 1)
                        .expand(-1, -1, d))                   # (G, El*C, D)
    # Experts lead: (El, G*C, D) @ (El, D, F).
    xe = x_ec.reshape(g, el, cap, d).transpose(0, 1).reshape(el, g * cap, d)
    if cols is not None:
        xe, d = xe[..., cols[0]:cols[1]], cols[1] - cols[0]
    u = torch.bmm(xe, w_up.to(cdt))
    gt = torch.bmm(xe, w_gate.to(cdt)) if w_gate is not None else None
    h = _activate(cfg.activation, u, gt) if activate is None \
        else activate(u, gt)
    y = torch.bmm(h, w_down.to(cdt))                         # (El, G*C, D)
    y = y.reshape(el, g, cap, d).transpose(0, 1) \
        * w[..., None].to(cdt)                                # (G, El, C, D)
    rows = (idx + torch.arange(g, device=x.device)[:, None, None]
            * (t + 1)).reshape(-1)
    out = torch.zeros((g * (t + 1), d), dtype=cdt, device=x.device) \
        .index_add(0, rows, y.reshape(-1, d))
    return out.reshape(g, t + 1, d)[:, :t], me, ce


def _moe_on_mesh(params: dict, cfg: ArchConfig, x: DTensor):
    """`_moe_groups` on each rank's shards (`local_map`): its rows of
    the batch (x's groups, over the batch axes) and its experts (the
    expert axis over "model", expert parallelism).  The router comes
    whole, and the expert weights whole over "data" (`fsdp_gather`).
    Over the mesh dims that shard the experts, each rank's output and
    its x gradient cover its experts only, so both are declared
    ``Partial`` there, and only the rank at coordinate 0 counts the
    statistics; the weights' gradients are ``Partial`` over the batch
    axes (each rank's rows).  DTensor plans no sort, scatter or
    `index_add`, so the routing runs on local tensors.

    Where the weights stay (a decode step, `rules.weights_stay`) each
    rank keeps its d_model shard of them over "data" instead: its
    groups are gathered there, the router's logits are
    `weight_product`'s, and its up products are partial sums over
    "data", reduce-scattered by slot rows, activated, and the
    activations gathered again (`_moe_groups`' `cols`): a few rows of
    slots cross the mesh, not the weights.  `x` comes gathered whole
    over "model" (`ACT_GROUPS`, the callers' `ACT_TOKENS`).  Returns
    (out on the residual stream's sequence shards, `ACT_TOKENS_SEQ`:
    the partial sums reduce-scattered, a decode step's one row
    all-reduced; the two statistics reduced over the whole mesh)."""
    x = constrain(x, ACT_GROUPS)
    mesh = x.device_mesh
    names = [n for n in ("w_up", "w_gate", "w_down") if n in params]
    stay = weights_stay(x, params["w_up"])
    ws = [params[n] if stay else fsdp_gather(params[n]) for n in names]
    w_pl = tuple(ws[0].placements)     # the three share one spec
    # the mesh dims that shard d_model (w_up's rows) where weights stay
    dp = [i for i, p in enumerate(w_pl) if p == Shard(1)]
    if dp:
        x = x.redistribute(mesh, [Replicate() if i in dp else p
                                  for i, p in enumerate(x.placements)])
        router = weight_product(x, params["router"],
                                dtype_of(cfg.compute_dtype))
    else:
        router = constrain(params["router"], P())
    x_pl = tuple(x.placements)
    ep = [i for i, p in enumerate(w_pl) if p == Shard(0)]
    batch = [i for i, p in enumerate(x_pl) if p == Shard(0)]
    part = tuple(Partial() if i in ep else Shard(2) if i in dp else p
                 for i, p in enumerate(x_pl))
    stats = tuple(Partial() if i in ep or i in batch else Replicate()
                  for i in range(len(x_pl)))
    w_grad = tuple(tuple(Partial() if i in batch else p
                         for i, p in enumerate(w.placements)) for w in ws)
    lead = all(mesh.get_local_rank(i) == 0 for i in ep)
    cols = local_range(mesh, w_pl, 1, cfg.d_model) if dp else None
    ways = math.prod(mesh.size(i) for i in dp)

    def activate(u, gate):
        """The partial up products summed over `dp` and activated, on
        1/`ways` of the slot rows each: reduce-scatter, activate,
        all-gather."""
        parts = u if gate is None else torch.cat([u, gate], dim=-1)
        rows = parts.shape[1]
        parts = torch.nn.functional.pad(parts, (0, 0, 0, -rows % ways))
        for i in dp:
            parts = funcol.reduce_scatter_tensor(parts, "sum", 1, (mesh, i))
        h = _activate(cfg.activation, parts) if gate is None else \
            _activate(cfg.activation, *parts.chunk(2, dim=-1))
        for i in reversed(dp):
            h = funcol.all_gather_tensor(h, 1, (mesh, i))
        return h[:, :rows]

    def core(xl, rl, *wl):
        held = dict(zip(names, wl))
        out, me, ce = _moe_groups(
            xl, None if dp else rl, held["w_up"], held.get("w_gate"),
            held["w_down"], cfg=cfg,
            experts=local_range(mesh, w_pl, 0, cfg.n_experts),
            n_groups=x.shape[0], cols=cols,
            activate=activate if dp else None, logits=rl if dp else None)
        if not lead:        # its statistics, and their gradient, are 0
            me, ce = me * 0.0, ce * 0.0
        return out, me, ce

    out, me, ce = local_map(
        core, out_placements=(part, stats, stats),
        in_placements=(x_pl, tuple(router.placements))
        + tuple(tuple(w.placements) for w in ws),
        in_grad_placements=(part, stats) + w_grad,
        device_mesh=mesh)(x, router, *ws)
    return (constrain(out, ACT_TOKENS_SEQ), constrain(me, P(None)),
            constrain(ce, P(None)))


def moe_apply(params: dict, cfg: ArchConfig, x: torch.Tensor):
    """x: (G, T, D); G is the group axis (the batch).  Returns (out
    (G, T, D) in the compute type, aux loss, a float32 scalar).  Over a
    training mesh (x a DTensor) each rank routes its rows and computes
    its experts (`_moe_on_mesh`)."""
    if isinstance(x, DTensor):
        out, me, ce = _moe_on_mesh(params, cfg, x)
    else:
        out, me, ce = _moe_groups(
            x, params["router"], params["w_up"], params.get("w_gate"),
            params["w_down"], cfg=cfg, experts=(0, cfg.n_experts),
            n_groups=x.shape[0])
    return out, cfg.n_experts * torch.sum(me * ce)
