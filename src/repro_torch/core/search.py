"""DOSA one-loop gradient-descent co-search (paper Sec. 5), on torch.

The PyTorch port of `repro.core.search`.  Search strategy (Table 5):
temporal + spatial tiling factors by GD (Adam), the spatial dataflow
and tensor bypass fixed by the target's `ArchSpec` (Gemmini
weight-stationary C|K by default, Table 4), loop ordering by
exhaustive enumeration — either *iterative* (re-selected after every
rounding, Sec. 5.2.1) or *softmax-weighted in the loss* (Sec. 5.2.2,
Eqs. 15-17).

Protocol details implemented from the paper:
* start points: random hardware + CoSA-seeded mappings (Sec. 5.1);
* start-point rejection at 10x the best seen start (Sec. 5.3.1);
* rounding to nearest-divisor valid mappings every `round_every` steps,
  innermost->outermost (Sec. 5.3.2);
* backing-store factors inferred, validity penalty sum max(1-f, 0)
  (Sec. 5.3.3, Eq. 18);
* EDP of the full network as the loss (Eq. 14), descended as log(EDP);
* every differentiable-model step and every oracle evaluation of a
  rounded mapping counts as one sample (Sec. 6.3).

Three engines are ported, and all run on the device the caller names
(``"cuda"`` by default):

* the *sequential* reference driver (``dosa_search(...,
  population=None)``) runs each start point's Adam descent step by
  step, rounding and re-selecting orderings through the host;
* the *host-batched* engine (``dosa_search(..., population=P,
  fused=False)``) runs each GD segment of a whole population chunk on
  the device, then returns to the host at every rounding point: the
  chunk is rounded on the host (`rounding.round_population`), its
  orderings re-selected by one batched device table plus coordinate
  descent (`select_orderings_population_spec`), and oracle-evaluated;
* the *fused* engine (``dosa_search(..., population=P)``, the default)
  runs a whole population chunk on the device — every GD segment
  (Adam over the batched model, per-member gradients from one
  `torch.autograd.grad` of the summed loss), device nearest-divisor
  rounding, ordering coordinate descent and best-EDP tracking — with
  no value read back to the host until the chunk ends.  Oracle
  accounting then replays over the read-back in the reference's
  host-batched order, so both engines report the reference's
  ``best_edp``, ``n_evals`` and ``history`` for a given seed.

``SearchConfig.surrogate`` (a `surrogate.TrainedModel`) makes every
engine descend through the learned latency model (Sec. 6.5): the loss
composes the MLP's per-layer latency with the analytical energy, its
features built on the device by `calibration.traced_features`.

Start points come from the host CoSA protocol by default (Sec. 5.3.1);
``SearchConfig.start_points`` selects seeding on the device instead
("random-device" / "cosa-device", `mapping.seed_population`): each
chunk's uniforms come from a `torch.Generator` seeded from (seed,
chunk), so a large population never exists on the host.  The fused
engine only.

The engines report the reference's telemetry spans (`obs.telemetry`):
``engine.build`` on an engine-cache miss, ``search.starts`` /
``search.fused_dispatch`` / ``search.readback`` / ``search.oracle`` in
the fused driver, ``search.gd_segment`` / ``search.rounding`` /
``search.ordering`` / ``search.oracle`` in the host-batched one.

The fused engine shards its population axis over a 1-D "pop" device
mesh (``SearchConfig.shards``; auto-resolved over the devices the
caller names, `launch.mesh.auto_pop_shards`).  ``device`` may be a
sequence of devices, the mesh: ``["cuda:0", "cuda:1"]`` is two cards,
and a repeated device (``["cpu"] * 4``, ``["cuda:0"] * 2``) holds
several shards.  A single device (``"cuda"`` is the current card) is a
one-device mesh: several cards are opt-in, since on them the shards'
host threads take longer than one shard does (PERF.md).
Every segment op is per member, so the shards run concurrently, one
host thread each (`sharding.rules.shard_map`), never talk to each other
during a chunk, and give read-backs bit-identical to ``shards=1``; the
per-shard best trackers reduce once after the join
(`_reduce_population_best`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_devices
from ..launch.mesh import DeviceMesh, auto_pop_shards, make_pop_mesh
from ..obs import telemetry as _obs
from ..sharding.rules import (member_spec, segment_member_spec, shard_map,
                              shard_tensor)
from .arch import GemminiHW
from .archspec import (ArchSpec, CompiledSpec, GEMMINI_SPEC, HWConfig,
                       compile_spec, resolve_spec)
from .cosa import cosa_map_workload
from .hw_infer import minimal_hw_for, random_hw_for
from .lru import LRUCache
from .mapping import TEMPORAL, SPATIAL, Mapping, stack_mappings
from .mapping import unstack_mappings
from .model import (PopulationBest, SpecHW, _spec_hw_from_params,
                    capacities, capacity_penalty_spec, infer_hw_spec,
                    layer_el_all_orderings_spec,
                    layer_el_all_orderings_population_spec,
                    population_best_init, population_best_update,
                    population_edp_spec, relu, validity_penalty,
                    workload_eval_spec)
from .oracle import evaluate_workload
from .problem import Workload
from .rounding import (round_all, round_population, rounding_tables,
                       _round_population_core)
# Free optimization sites of the default (Gemmini) target; generic
# targets read `compile_spec(spec).free_mask`.
from .surrogate import FREE_MASK  # noqa: F401

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def build_f(theta: torch.Tensor, dims: torch.Tensor,
            free_mask: torch.Tensor) -> torch.Tensor:
    """theta (..., L, 2, n_levels, 7) log-factors -> full factor tensor
    with inferred backing-store temporal factors (Sec. 5.3.3).
    dims: (L, 7) float32; free_mask: (2, n_levels, 7) bool."""
    f = torch.where(free_mask, torch.exp(theta), 1.0)
    n_levels = f.shape[-2]
    inner = f[..., SPATIAL, 0, :]
    for k in range(2):
        for lvl in range(n_levels):
            if (k, lvl) != (SPATIAL, 0):
                inner = inner * f[..., k, lvl, :]
    inner = inner / f[..., TEMPORAL, -1, :]
    temporal = torch.cat([f[..., TEMPORAL, :-1, :],
                          (dims / inner)[..., None, :]], dim=-2)
    return torch.stack([f[..., SPATIAL, :, :], temporal], dim=-3)


def theta_from_mappings(mappings: list[Mapping],
                        free_mask: np.ndarray) -> np.ndarray:
    """(L, 2, n_levels, 7) float64 log-factors at the free sites."""
    fs, _ = stack_mappings(mappings)
    theta = np.zeros_like(fs)
    np.log(np.maximum(fs, 1.0), out=theta, where=free_mask[None])
    return theta


def theta_from_population(population: list[list[Mapping]],
                          free_mask: np.ndarray) -> np.ndarray:
    """(P, L, 2, n_levels, 7) log-factors for a population of workload
    mappings."""
    return np.stack([theta_from_mappings(ms, free_mask)
                     for ms in population])


def orders_from_population(population: list[list[Mapping]]) -> np.ndarray:
    """(P, L, n_levels) per-level ordering choices for a population."""
    return np.stack([np.stack([m.order for m in ms]) for ms in population])


def _theta_tensor(theta: np.ndarray, device) -> torch.Tensor:
    """float64 log-factors rounded once to float32, on `device` — the
    value every engine restarts GD from after a rounding point."""
    return torch.from_numpy(theta.astype(np.float32)).to(device)


@dataclasses.dataclass
class SearchConfig:
    steps: int = 1490
    round_every: int = 500
    n_start_points: int = 7
    lr: float = 0.01
    penalty_weight: float = 10.0
    ordering_mode: str = "iterative"   # "none" | "iterative" | "softmax"
    softmax_temp: float = 10.0
    spec: ArchSpec | None = None       # target architecture (None: Gemmini)
    fixed_hw: GemminiHW | HWConfig | None = None  # freeze PE dims (Sec. 6.5)
    fix_pe_only: bool = True           # Sec. 6.5 frees buffer sizes
    reject_factor: float = 10.0
    max_reject_tries: int = 10
    seed: int = 0
    latency_model: Callable | None = None  # (mappings, workload) -> EDP
    surrogate: object | None = None    # TrainedModel: GD descends
    #   through the DNN residual/direct latency model (Sec. 6.5),
    #   calibrated for `spec`'s featurization (core.calibration).
    shards: int | None = None          # fused-engine population shard
    #   count over the "pop" device mesh.  None auto-resolves to the
    #   largest divisor of the population chunk that fits the device
    #   count (1 on a single device).  Sharded and single-device runs
    #   are bit-identical per seed; a host driver knob only, never part
    #   of the engine cache key.
    start_points: str = "cosa"         # "cosa": host CoSA protocol with
    #   rejection (Sec. 5.3.1); "random-device" / "cosa-device": seed the
    #   population on the device (`mapping.seed_population`), fused
    #   engine only, no start oracle evals (start_edps stays empty).

    def __post_init__(self):
        """Fail fast on configurations the reference rejects."""
        if self.ordering_mode not in ("none", "iterative", "softmax"):
            raise ValueError(
                f"unknown ordering_mode {self.ordering_mode!r}; choose "
                "'none', 'iterative' or 'softmax' (Sec. 5.2)")
        for field in ("steps", "round_every", "n_start_points"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{field} must be a positive int, "
                                 f"got {v!r}")
        if self.lr <= 0.0:
            raise ValueError(f"lr must be positive, got {self.lr!r}")
        if self.shards is not None and (not isinstance(self.shards, int)
                                        or self.shards < 1):
            raise ValueError(f"shards must be a positive int or None "
                             f"(auto), got {self.shards!r}")
        if self.start_points not in ("cosa", "random-device",
                                     "cosa-device"):
            raise ValueError(
                f"unknown start_points {self.start_points!r}; choose "
                "'cosa' (host protocol), 'random-device' or "
                "'cosa-device' (on-device seeding)")
        # A single-target surrogate must belong to this config's target:
        # a model calibrated for another spec's physics (or feature
        # width) is rejected here with calibration's own diagnostics.
        sur = self.surrogate
        if sur is not None and not isinstance(sur, dict) \
                and hasattr(sur, "n_features") and hasattr(sur, "spec_name"):
            from .calibration import check_surrogate
            check_surrogate(sur, resolve_spec(self.spec))


@dataclasses.dataclass
class SearchResult:
    best_edp: float
    best_mappings: list[Mapping]
    best_hw: GemminiHW | HWConfig
    history: list[tuple[int, float]]   # (cumulative evals, best oracle EDP)
    n_evals: int
    start_edps: list[float]


def _cspec(cfg: SearchConfig) -> CompiledSpec:
    return resolve_spec(cfg.spec)


def _pe_cap(cfg: SearchConfig, cspec: CompiledSpec) -> float:
    """Spatial-factor bound: a frozen hardware point's array side, else
    the spec's own PE bound (fixed silicon side or search cap)."""
    return float(cfg.fixed_hw.pe_dim if cfg.fixed_hw is not None
                 else cspec.pe_cap)


def _fixed_spec_hw(cfg: SearchConfig, cspec: CompiledSpec,
                   device) -> SpecHW | None:
    """The frozen SpecHW when the whole hardware point is fixed
    (Sec. 6.5 buffer-and-mapping-frozen mode), else None."""
    if cfg.fixed_hw is None or cfg.fix_pe_only:
        return None
    c_pe, cap_words = cspec.hw_words(cfg.fixed_hw)
    return SpecHW(
        c_pe=torch.tensor(c_pe, dtype=torch.float32, device=device),
        cap_words=torch.as_tensor(np.asarray(cap_words, dtype=np.float32),
                                  device=device))


# ---------------------------------------------------------------------------
# Loss functions
# ---------------------------------------------------------------------------

def _spatial_cap_penalty(f: torch.Tensor, pe_cap: float,
                         sites) -> torch.Tensor:
    if not sites:
        return f.new_zeros(f.shape[:-4])
    s = torch.stack([f[..., SPATIAL, lvl, d] for (lvl, d) in sites], -1)
    return relu(s / pe_cap - 1.0).sum(dim=(-2, -1))


def _make_loss_fn(workload: Workload, cfg: SearchConfig, device):
    """Batched loss ``(theta (..., L, 2, n_levels, 7), orders (..., L,
    n_levels)) -> (...)``: one value per start point, so the gradient of
    the sum is each member's own gradient.  Returns the loss plus the
    workload constant tensors on `device`."""
    cspec = _cspec(cfg)
    dims = torch.as_tensor(workload.dims_array().astype(np.float32),
                           device=device)
    strides = torch.as_tensor(workload.strides_array().astype(np.float32),
                              device=device)
    repeats = torch.as_tensor(workload.repeats_array().astype(np.float32),
                              device=device)
    pe_cap = _pe_cap(cfg, cspec)
    hw_fixed = _fixed_spec_hw(cfg, cspec, device)
    free_mask = cspec.free_mask_t(device)
    sur = cfg.surrogate
    if sur is not None:
        # Spec-generic calibration path: validate the trained model's
        # feature width against the target's featurization up front,
        # then put its weights and normalization on the device once.
        from .calibration import check_surrogate, traced_features
        from .surrogate import DIRECT_CLIP, RESIDUAL_CLIP, mlp_apply
        check_surrogate(sur, cspec)
        sur_params = [{k: v.to(device) for k, v in p.items()}
                      for p in sur.params]
        x_mean = torch.as_tensor(np.asarray(sur.x_mean, dtype=np.float32),
                                 device=device)
        x_std = torch.as_tensor(np.asarray(sur.x_std, dtype=np.float32),
                                device=device)
        logdims = torch.log(dims)

    def surrogate_latency(theta, orders, hw, lat_analytical):
        """Per-layer latency through the learned model (differentiable:
        the features are the log-factors, theta at the spec's free
        sites)."""
        feats = traced_features(cspec, theta, orders, logdims, hw)
        out = mlp_apply(sur_params, (feats - x_mean) / x_std)  # (..., L)
        if sur.kind == "residual":
            return lat_analytical * torch.exp(
                torch.clamp(out, -RESIDUAL_CLIP, RESIDUAL_CLIP))
        return torch.exp(torch.clamp(out, 0.0, DIRECT_CLIP))

    def edp_fixed_orders(theta, f, orders):
        edp, (en, lat, hw) = workload_eval_spec(cspec, f, orders, strides,
                                                repeats, hw=hw_fixed)
        if sur is not None:
            lat_s = surrogate_latency(theta, orders, hw, lat / repeats)
            edp = en.sum(dim=-1) * (lat_s * repeats).sum(dim=-1)
        return edp

    def edp_softmax(f):
        hw = infer_hw_spec(cspec, f, strides) if hw_fixed is None \
            else hw_fixed
        e, lat = layer_el_all_orderings_spec(
            cspec, f, strides, hw.c_pe[..., None],
            hw.cap_words[..., None, :])                  # (..., L, combos)
        el = e * lat
        inv = torch.amin(el, dim=-1, keepdim=True) / el
        w = torch.softmax(cfg.softmax_temp * inv, dim=-1)        # Eq. 16
        e_l = (w * e).sum(dim=-1) * repeats
        l_l = (w * lat).sum(dim=-1) * repeats
        return e_l.sum(dim=-1) * l_l.sum(dim=-1)                  # Eq. 17

    def fixed_silicon_penalty(f):
        """Overflow of fixed-capacity levels (e.g. TPU VMEM) — active
        even in mapping-first mode, where no searched buffer grows to
        absorb the tile."""
        caps = capacities(f, strides)
        pen = 0.0
        for (i, words) in cspec.fixed_capacity:
            req = sum(caps[..., i, t] for t in range(3)
                      if cspec.b_matrix[i, t])
            pen = pen + relu(req / words - 1.0).sum(-1)
        return pen

    def loss(theta, orders):
        f = build_f(theta, dims, free_mask)
        if cfg.ordering_mode == "softmax" and sur is None:
            edp = edp_softmax(f)
        else:
            edp = edp_fixed_orders(theta, f, orders)
        pen = validity_penalty(f) \
            + _spatial_cap_penalty(f, pe_cap, cspec.spatial_sites)
        if hw_fixed is not None:
            pen = pen + capacity_penalty_spec(cspec, f, strides, hw_fixed)
        elif cspec.fixed_capacity:
            pen = pen + fixed_silicon_penalty(f)
        return torch.log(edp) + cfg.penalty_weight * pen

    return loss, dims, strides, repeats


def _loss_grad(loss):
    """theta -> per-start gradient of `loss`: the members are
    independent, so the gradient of the summed loss is each member's
    own gradient."""
    def grad(theta, orders):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(th, orders).sum(), th)
        return g
    return grad


# Engine cache: per (workload, config fields the engine reads, device),
# the loss closure plus its constant tables already on the device.
# Fields that only steer the host driver (steps, seed, rejection
# protocol, latency_model) are excluded on purpose.  The surrogate is
# keyed by identity: its weights are copied into the engine, and the
# engine holds the config, so an id is not reused while it is cached.
# Bounded LRU with eviction accounting: a long-lived co-search server
# streams unbounded (workload, config) variety through this cache;
# `engine_cache_stats()` surfaces its counters.
_ENGINE_CACHE = LRUCache(maxsize=16)


def _engine_key(workload: Workload, cfg: SearchConfig, kind: str, device):
    return (kind, workload, cfg.spec, cfg.lr, cfg.penalty_weight,
            cfg.ordering_mode, cfg.softmax_temp, cfg.fixed_hw,
            cfg.fix_pe_only,
            id(cfg.surrogate) if cfg.surrogate is not None else None,
            str(device))


def _cached_engine(workload: Workload, cfg: SearchConfig, kind: str,
                   device, build):
    """The cached engine of (workload, cfg, kind, device), or a new one
    built under an ``engine.build`` span (timed by the telemetry clock)
    whose seconds the cache keeps per entry."""
    key = _engine_key(workload, cfg, kind, device)
    hit = _ENGINE_CACHE.get(key, None)
    if hit is not None:
        return hit
    label = f"{kind}:{workload.name}"
    value, build_s = _obs.profile_build(build, kind=kind, cache="search",
                                        label=label)
    _ENGINE_CACHE.put(key, value)
    _ENGINE_CACHE.note_build_time(label, build_s)
    return value


def engine_cache_stats() -> dict:
    """Hit/miss/eviction counters of the engine cache — the serving
    layer's warm-engine health metric."""
    return _ENGINE_CACHE.stats()


def _grad_engine(workload: Workload, cfg: SearchConfig, kind: str,
                 device):
    """(grad_fn, dims, strides, repeats) of the loss batched over
    leading dims, cached per (workload, cfg, kind, device)."""
    dev = resolve_device(device)

    def build():
        loss, dims, strides, repeats = _make_loss_fn(workload, cfg, dev)
        return _loss_grad(loss), dims, strides, repeats
    return _cached_engine(workload, cfg, kind, dev, build)


def make_loss(workload: Workload, cfg: SearchConfig,
              device=DEFAULT_DEVICE):
    """The sequential driver's gradient engine (`_grad_engine`)."""
    return _grad_engine(workload, cfg, "sequential", device)


def make_population_runner(workload: Workload, cfg: SearchConfig,
                           device=DEFAULT_DEVICE):
    """The host-batched engine's gradient engine, cached under its own
    kind, as the reference keys its segment runner."""
    return _grad_engine(workload, cfg, "population", device)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def adam_step(theta, grad, m, v, t, lr: float):
    """One Adam update.  `t` is the float32 step count as a tensor: the
    bias corrections ``b ** t`` are float32 powers, as in the
    reference's jitted step (its `t` arrives as a traced float32), while
    ``1 - b`` is formed from the Python constants."""
    m = _ADAM_B1 * m + (1 - _ADAM_B1) * grad
    v = _ADAM_B2 * v + (1 - _ADAM_B2) * grad * grad
    mh = m / (1 - _ADAM_B1 ** t)
    vh = v / (1 - _ADAM_B2 ** t)
    return theta - lr * mh / (torch.sqrt(vh) + _ADAM_EPS), m, v


def _adam_segment(grad_fn, lr: float, theta, orders, n_steps: int):
    """One GD segment of `n_steps` Adam steps on the device, fresh
    momentum (the reference resets it after every rounding)."""
    ts = torch.arange(1, n_steps + 1, dtype=theta.dtype,
                      device=theta.device)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    for i in range(n_steps):
        g = grad_fn(theta, orders)
        theta, m, v = adam_step(theta, g, m, v, ts[i], lr)
    return theta


def make_segment_runner(pop_grad, lr: float):
    """GD-segment executor shared by the batched population engine's
    API and the fleet's: advance a whole population of log-factor
    tensors by `n_steps` Adam steps (fresh momentum) through
    `pop_grad(theta, *args) -> (value, grad)`.  Extra positional `args`
    are carried through to `pop_grad` unchanged; `n_steps` is
    keyword-only.  (The reference also donates the incoming buffer;
    here each step makes new tensors, with the same result.)"""
    def run_segment(theta, *args, n_steps: int):
        return _adam_segment(lambda th, _: pop_grad(th, *args)[1], lr,
                             theta, None, n_steps)

    return run_segment


def _segment_lengths(steps: int, round_every: int) -> list[int]:
    """GD-step counts between consecutive rounding points: the sequential
    driver rounds at every multiple of `round_every` and at `steps`."""
    full, rem = divmod(steps, round_every)
    return [round_every] * full + ([rem] if rem else [])


# ---------------------------------------------------------------------------
# Loop-ordering selection (Sec. 5.2.1): coordinate descent over the
# 3**(n_levels-1) per-layer combos against network EDP (Eq. 14).
# ---------------------------------------------------------------------------

def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _cd_orderings(e: torch.Tensor, lat: torch.Tensor,
                  n_passes: int = 2) -> torch.Tensor:
    """Coordinate descent over per-layer ordering choices, batched over
    leading dims.  e, lat: (..., L, n_combos) repeat-scaled
    energies/latencies.  Returns (..., L) int64 combo indices minimizing
    (sum e) * (sum l): each pass re-derives the totals, then sweeps the
    layers in order, each taking the first minimum (`torch.argmin`)."""
    L = e.shape[-2]
    choice = torch.zeros(e.shape[:-1], dtype=torch.int64, device=e.device)
    with torch.no_grad():
        for _ in range(n_passes):
            e_tot = _seq_sum(torch.gather(e, -1, choice[..., None])[..., 0])
            l_tot = _seq_sum(
                torch.gather(lat, -1, choice[..., None])[..., 0])
            for i in range(L):
                ei, li = e[..., i, :], lat[..., i, :]
                c0 = choice[..., i, None]
                e_rest = e_tot - torch.gather(ei, -1, c0)[..., 0]
                l_rest = l_tot - torch.gather(li, -1, c0)[..., 0]
                c = torch.argmin((e_rest[..., None] + ei)
                                 * (l_rest[..., None] + li), dim=-1)
                choice = torch.cat([choice[..., :i], c[..., None],
                                    choice[..., i + 1:]], dim=-1)
                e_tot = e_rest + torch.gather(ei, -1, c[..., None])[..., 0]
                l_tot = l_rest + torch.gather(li, -1, c[..., None])[..., 0]
    return choice


def select_orderings_spec(cspec: CompiledSpec, fs: torch.Tensor,
                          strides: torch.Tensor, repeats: torch.Tensor,
                          hw: SpecHW, n_passes: int = 2) -> np.ndarray:
    """Iterative ordering re-selection of one workload mapping: fs
    (L, 2, n_levels, 7) on the device; returns (L, n_levels) numpy."""
    e, lat = layer_el_all_orderings_spec(cspec, fs, strides,
                                         hw.c_pe[..., None],
                                         hw.cap_words[..., None, :])
    rep = repeats[:, None]
    choice = _cd_orderings(e * rep, lat * rep, n_passes=n_passes)
    return cspec.combos[choice.cpu().numpy()]


def select_orderings(fs: torch.Tensor, strides: torch.Tensor,
                     repeats: torch.Tensor, hw, n_passes: int = 2
                     ) -> np.ndarray:
    """Legacy Gemmini entry point (`hw`: model.HWParams)."""
    return select_orderings_spec(compile_spec(GEMMINI_SPEC), fs, strides,
                                 repeats, _spec_hw_from_params(hw),
                                 n_passes)


def _population_hw(cspec: CompiledSpec, fs: torch.Tensor,
                   strides: torch.Tensor, hw_fixed: SpecHW | None) -> SpecHW:
    """One hardware point per member of a (P, L, 2, n_levels, 7)
    population: the frozen one broadcast, else each member's inferred
    minimal hardware."""
    if hw_fixed is None:
        return infer_hw_spec(cspec, fs, strides)
    P = fs.shape[0]
    return SpecHW(c_pe=hw_fixed.c_pe.expand(P),
                  cap_words=hw_fixed.cap_words.expand(P, cspec.n_levels))


def _population_choice(cspec: CompiledSpec, fs: torch.Tensor,
                       strides: torch.Tensor, repeats: torch.Tensor,
                       hws: SpecHW, n_passes: int = 2) -> torch.Tensor:
    """(P, L) combo indices: every member's (L, n_combos) energy and
    latency tables in one batched computation, then coordinate descent
    per member, all on the population's device."""
    e, lat = layer_el_all_orderings_population_spec(cspec, fs, strides, hws)
    rep = repeats[None, :, None]
    return _cd_orderings(e * rep, lat * rep, n_passes=n_passes)


def select_orderings_population_spec(cspec: CompiledSpec,
                                     fs_pop: torch.Tensor,
                                     strides: torch.Tensor,
                                     repeats: torch.Tensor, hws: SpecHW,
                                     n_passes: int = 2) -> np.ndarray:
    """Population-wide iterative ordering re-selection of the
    host-batched engine: fs_pop (P, L, 2, n_levels, 7) on the device,
    hws with (P,) / (P, n_levels) leaves.  Returns (P, L, n_levels)
    numpy."""
    choice = _population_choice(cspec, fs_pop, strides, repeats, hws,
                                n_passes)
    return cspec.combos[choice.cpu().numpy()]


def select_orderings_population(fs_pop: torch.Tensor, strides: torch.Tensor,
                                repeats: torch.Tensor, hws,
                                n_passes: int = 2) -> np.ndarray:
    """Legacy Gemmini entry point (`hws`: model.HWParams, (P,)
    leaves)."""
    return select_orderings_population_spec(
        compile_spec(GEMMINI_SPEC), fs_pop, strides, repeats,
        _spec_hw_from_params(hws), n_passes)


# ---------------------------------------------------------------------------
# The fused engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedEngine:
    """A (workload, cfg, device) engine: per-member loss gradient plus
    every static table on the device.  `run` advances a population chunk
    through all its segments without reading anything back."""

    cspec: CompiledSpec
    cfg: SearchConfig
    grad_fn: Callable
    dims: torch.Tensor
    strides: torch.Tensor
    repeats: torch.Tensor
    tables: object
    free_mask: torch.Tensor
    combos: torch.Tensor
    pe_cap: int
    hw_fixed: SpecHW | None

    def segment(self, theta, orders, best, n_steps: int):
        """Adam -> device rounding -> ordering CD -> best tracking."""
        cspec = self.cspec
        theta = _adam_segment(self.grad_fn, self.cfg.lr, theta, orders,
                              n_steps)
        with torch.no_grad():
            f_cont = build_f(theta, self.dims, self.free_mask)
            f_round, theta = _round_population_core(cspec, self.tables,
                                                    f_cont, self.pe_cap)
            if self.cfg.ordering_mode in ("iterative", "softmax"):
                hws = _population_hw(cspec, f_round, self.strides,
                                     self.hw_fixed)
                orders = self.combos[_population_choice(
                    cspec, f_round, self.strides, self.repeats, hws)]
            edp = population_edp_spec(cspec, f_round, orders, self.strides,
                                      self.repeats, hw=self.hw_fixed)
            best = population_best_update(best, edp, f_round, orders)
        return theta, orders, best, (f_round, orders, edp)

    def run(self, theta, orders, *, n_full: int, rem: int, seg_len: int):
        """Advance a (P, L, 2, n_levels, 7) population through `n_full`
        segments of `seg_len` GD steps plus an optional `rem`-step tail.
        Returns ``((f_rounded, orders, model_edp), best)`` with a leading
        per-segment axis on the first tuple, all on the device."""
        best = population_best_init(theta, orders)
        outs = []
        for n_steps in [seg_len] * n_full + ([rem] if rem else []):
            theta, orders, best, out = self.segment(theta, orders, best,
                                                    n_steps)
            outs.append(out)
        ys = tuple(torch.stack(parts) for parts in zip(*outs))
        return ys, best


def make_fused_runner(workload: Workload, cfg: SearchConfig,
                      device=DEFAULT_DEVICE) -> FusedEngine:
    """The fused engine for (workload, cfg, device), cached."""
    dev = resolve_device(device)

    def build():
        cspec = _cspec(cfg)
        loss, dims, strides, repeats = _make_loss_fn(workload, cfg, dev)
        return FusedEngine(
            cspec=cspec, cfg=cfg, grad_fn=_loss_grad(loss), dims=dims,
            strides=strides, repeats=repeats,
            tables=rounding_tables(workload.dims_array(), dev),
            free_mask=cspec.free_mask_t(dev),
            combos=cspec.device_tables(dev)["combos"],
            pe_cap=int(_pe_cap(cfg, cspec)),
            hw_fixed=_fixed_spec_hw(cfg, cspec, dev))
    return _cached_engine(workload, cfg, "fused", dev, build)


def fused_engines(workload: Workload, cfg: SearchConfig,
                  mesh: DeviceMesh) -> dict[torch.device, FusedEngine]:
    """The fused engine of every device of `mesh`, built or fetched in
    the calling thread, so no shard's worker touches the engine cache
    or the tracer."""
    return {dev: make_fused_runner(workload, cfg, dev)
            for dev in mesh.devices}


def shard_population(theta, orders, shards: int, devices=DEFAULT_DEVICE):
    """Place a (P, ...) population on the "pop" mesh of `shards` of the
    devices `devices` names: each as `MemberShards`, one member block
    per device, which `run_fused` takes as placed.  No-op at shards=1.
    The drivers hand `run_fused` whole tensors and let `shard_map`
    split them; this is for a caller that places a population once."""
    if shards == 1:
        return theta, orders
    mesh = make_pop_mesh(shards, devices)
    return (shard_tensor(theta, mesh, member_spec(theta.dim() - 1)),
            shard_tensor(orders, mesh, member_spec(orders.dim() - 1)))


def _reduce_population_best(blocks) -> PopulationBest:
    """Cross-shard reduction of per-shard best trackers (shard order) to
    the single global winner, as the reference's `pmin`-style
    collective: each shard contributes only its local argmin, the
    global minimum EDP wins, a tie goes to the lowest-indexed shard,
    and the winner's factor tensor and orders are copied from its
    device.  Returns a singleton (leading axis 1) on the first shard's
    device, with no host read."""
    dev = blocks[0].edp.device
    edp, f, orders = [], [], []
    for b in blocks:
        i = torch.argmin(b.edp).reshape(1)        # first local minimum
        edp.append(b.edp.index_select(0, i).to(dev))
        f.append(b.f.index_select(0, i).to(dev))
        orders.append(b.orders.index_select(0, i).to(dev))
    w = torch.argmin(torch.cat(edp)).reshape(1)   # lowest shard on a tie
    return PopulationBest(edp=torch.cat(edp).index_select(0, w),
                          f=torch.cat(f).index_select(0, w),
                          orders=torch.cat(orders).index_select(0, w))


# The per-segment outputs of a fused run: (f_rounded (S, P, L, 2, nl,
# 7), orders (S, P, L, n_levels), model_edp (S, P)).
SEGMENT_OUT_SPECS = (segment_member_spec(4), segment_member_spec(2),
                      segment_member_spec(0))


def run_fused(engines: dict, mesh: DeviceMesh, args: tuple,
              in_specs: tuple, **statics):
    """Run a fused engine (`FusedEngine` or the fleet's) over the pop
    `mesh`: ``engine.run(*args, **statics)``.  At one shard the engine
    of the mesh's device runs `args` as they are.  Above, `shard_map`
    runs the engine of each shard's device on that shard's member
    blocks (split along `in_specs`), all shards concurrently; every
    segment op is per member, so the read-back, concatenated in shard
    order, is bit-identical to one shard.  The per-shard best trackers
    reduce once after the join (`_reduce_population_best`), so the
    sharded `best` is the global winner with leading axis 1 (at one
    shard it stays the per-member tracker)."""
    if mesh.size == 1:
        return engines[mesh.devices[0]].run(*args, **statics)

    def per_shard(*blocks):
        return engines[blocks[0].device].run(*blocks, **statics)

    ys, bests = shard_map(per_shard, mesh=mesh, in_specs=in_specs,
                          out_specs=(SEGMENT_OUT_SPECS, None))(*args)
    return ys, _reduce_population_best(bests)


def chunk_generator(seed: int, lo: int, device) -> torch.Generator:
    """The `torch.Generator` of the device-seeded chunk whose first
    member is `lo`: one stream per (seed, chunk), as the reference folds
    the chunk index into its key, so a chunk's draws do not depend on
    how many chunks came before it."""
    hi, low = np.random.SeedSequence(
        (int(seed), int(lo))).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(hi) << 31) ^ int(low))
    return gen


# ---------------------------------------------------------------------------
# Oracle accounting shared by both engines
# ---------------------------------------------------------------------------

def _oracle_edp(mappings, workload, cfg, cspec: CompiledSpec) -> float:
    if cfg.latency_model is not None:
        return cfg.latency_model(mappings, workload)
    hw = cfg.fixed_hw
    if hw is not None and cfg.fix_pe_only:
        # Sec. 6.5 protocol: PE dims frozen, buffers re-derived minimally.
        derived = minimal_hw_for(cspec, mappings, list(workload.layers))
        hw = dataclasses.replace(derived, pe_dim=cfg.fixed_hw.pe_dim)
    edp, _ = evaluate_workload(mappings, workload.layers,
                               hw=hw if hw is not None else None,
                               spec=cspec)
    return float(edp)


class _Recorder:
    """Sample accounting shared by the drivers: every
    differentiable-model step and every oracle evaluation counts as one
    sample (Sec. 6.3)."""

    def __init__(self, workload: Workload, cfg: SearchConfig,
                 cspec: CompiledSpec):
        self.workload, self.cfg, self.cspec = workload, cfg, cspec
        self.evals = 0
        if cspec.spec is GEMMINI_SPEC:
            hw0 = GemminiHW(1, 1.0, 1.0)
        else:
            hw0 = HWConfig(1, (1.0,) * len(cspec.searched_levels))
        self.best = SearchResult(best_edp=float("inf"), best_mappings=[],
                                 best_hw=hw0, history=[], n_evals=0,
                                 start_edps=[])

    def count(self, n: int = 1) -> None:
        self.evals += n

    def record(self, mappings: list[Mapping]) -> float:
        """Oracle-evaluate a rounded candidate, update the running best."""
        cfg, best = self.cfg, self.best
        edp = _oracle_edp(mappings, self.workload, cfg, self.cspec)
        self.evals += 1
        if edp < best.best_edp:
            best.best_edp = edp
            best.best_mappings = [m.copy() for m in mappings]
            hw = minimal_hw_for(self.cspec, mappings,
                                list(self.workload.layers))
            if cfg.fixed_hw is not None and cfg.fix_pe_only:
                hw = dataclasses.replace(hw, pe_dim=cfg.fixed_hw.pe_dim)
            elif cfg.fixed_hw is not None:
                hw = cfg.fixed_hw
            best.best_hw = hw
        best.history.append((self.evals, best.best_edp))
        return edp

    def finish(self) -> SearchResult:
        self.best.n_evals = self.evals
        return self.best


# ---------------------------------------------------------------------------
# Start-point generation with rejection (Sec. 5.3.1)
# ---------------------------------------------------------------------------

def _generate_start_point(workload: Workload, cfg: SearchConfig,
                          rng: np.random.Generator, best_start_edp: float,
                          rec: _Recorder):
    """One random-hardware + CoSA-seeded start point, rejected (up to
    `max_reject_tries` times) while its EDP exceeds `reject_factor` x the
    best start seen so far.  Returns (mappings, edp0, best_start_edp)."""
    cspec = rec.cspec
    mappings = None
    for _ in range(cfg.max_reject_tries):
        hw0 = cfg.fixed_hw if cfg.fixed_hw is not None \
            else random_hw_for(cspec, rng)
        cand = cosa_map_workload(list(workload.layers), hw0, spec=cspec)
        edp0 = _oracle_edp(cand, workload, cfg, cspec)
        rec.count()
        if edp0 <= cfg.reject_factor * best_start_edp:
            mappings = cand
            best_start_edp = min(best_start_edp, edp0)
            break
    if mappings is None:
        mappings = cand
    return mappings, edp0, best_start_edp


def _start_points(workload: Workload, cfg: SearchConfig, rec: _Recorder,
                  rng: np.random.Generator | None = None):
    """All start points, consuming one seeded RNG stream in the
    reference's order, so every engine descends from the same ones."""
    rng = np.random.default_rng(cfg.seed) if rng is None else rng
    starts, best_start_edp = [], float("inf")
    for _ in range(cfg.n_start_points):
        mappings, edp0, best_start_edp = _generate_start_point(
            workload, cfg, rng, best_start_edp, rec)
        rec.best.start_edps.append(edp0)
        starts.append(mappings)
    return starts


def generate_start_points(workload: Workload, cfg: SearchConfig,
                          rng: np.random.Generator | None = None):
    """All `cfg.n_start_points` start points, generated with the running
    population-wide rejection rule.  Returns (population, start_edps,
    n_evals_spent); the drivers consume the same per-start helper, so
    the start points are identical across engines for a given seed."""
    rec = _Recorder(workload, cfg, _cspec(cfg))
    population = _start_points(workload, cfg, rec, rng)
    return population, rec.best.start_edps, rec.evals


# ---------------------------------------------------------------------------
# Main search
# ---------------------------------------------------------------------------

def dosa_search(workload: Workload, cfg: SearchConfig,
                population: int | None = None, fused: bool = True,
                device=DEFAULT_DEVICE) -> SearchResult:
    """Run DOSA co-search on `device` (the card unless the caller asks
    for the CPU; a sequence of devices is the fused engine's pop mesh,
    the other engines run on its first).  `population=None` is the
    sequential reference driver; `population=P` advances the start
    points P at a time through the fused engine, or with
    ``fused=False`` through the host-batched one (same protocol, same
    sample counting, same start points for a given seed).  Routes
    through `api.run_request`, as the reference does."""
    from ..api import SearchRequest, run_request
    return run_request(SearchRequest(
        workload=workload, config=cfg, population=population,
        fused=fused, device=device)).result


def execute_search(workload: Workload, cfg: SearchConfig,
                   population: int | None = None, fused: bool = True,
                   device=DEFAULT_DEVICE) -> SearchResult:
    """Engine dispatch shared by `dosa_search` and `api.run_request`."""
    if cfg.start_points != "cosa" and (population is None or not fused):
        raise ValueError(
            f"start_points={cfg.start_points!r} seeds the population on "
            "device and only the fused engine consumes it; pass "
            "population=P with fused=True")
    devices = resolve_devices(device)
    dev = devices[0]
    if population is not None:
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        if fused:
            return _dosa_search_fused(workload, cfg, int(population),
                                      devices)
        return _dosa_search_batched(workload, cfg, int(population), dev)
    return _dosa_search_sequential(workload, cfg, dev)


def _ordering_hw(cfg: SearchConfig, cspec: CompiledSpec,
                 fs: torch.Tensor, strides: torch.Tensor) -> SpecHW:
    """Hardware point against which rounded candidates re-select their
    loop orderings: the frozen config when fully fixed, else inferred
    minimal hardware."""
    fixed = _fixed_spec_hw(cfg, cspec, fs.device)
    if fixed is not None:
        return fixed
    return infer_hw_spec(cspec, fs, strides)


def _dosa_search_sequential(workload: Workload, cfg: SearchConfig,
                            device: torch.device) -> SearchResult:
    cspec = _cspec(cfg)
    rng = np.random.default_rng(cfg.seed)
    grad_fn, dims_t, strides_t, repeats_t = make_loss(workload, cfg,
                                                      device)
    dims = workload.dims_array()
    free_mask_t = cspec.free_mask_t(device)
    pe_cap = int(_pe_cap(cfg, cspec))
    ts = torch.arange(1, cfg.steps + 1, dtype=torch.float32, device=device)

    rec = _Recorder(workload, cfg, cspec)
    best_start_edp = float("inf")

    for _ in range(cfg.n_start_points):
        # ---- start-point generation with rejection (Sec. 5.3.1)
        mappings, edp0, best_start_edp = _generate_start_point(
            workload, cfg, rng, best_start_edp, rec)
        rec.best.start_edps.append(edp0)
        rec.record(mappings)

        theta = _theta_tensor(theta_from_mappings(mappings, cspec.free_mask),
                              device)
        orders = torch.as_tensor(np.stack([m.order for m in mappings]),
                                 device=device)
        m_t = torch.zeros_like(theta)
        v_t = torch.zeros_like(theta)
        t = 0

        for step in range(1, cfg.steps + 1):
            t += 1
            grad = grad_fn(theta, orders)
            theta, m_t, v_t = adam_step(theta, grad, m_t, v_t, ts[t - 1],
                                        cfg.lr)
            rec.count()
            if step % cfg.round_every == 0 or step == cfg.steps:
                f_cont = build_f(theta, dims_t, free_mask_t)
                rounded = round_all(f_cont.cpu().numpy(),
                                    orders.cpu().numpy(), dims,
                                    pe_cap=pe_cap, spec=cspec)
                if cfg.ordering_mode in ("iterative", "softmax"):
                    fs_r = torch.from_numpy(
                        stack_mappings(rounded)[0].astype(np.float32)
                    ).to(device)
                    hwp = _ordering_hw(cfg, cspec, fs_r, strides_t)
                    new_orders = select_orderings_spec(
                        cspec, fs_r, strides_t, repeats_t, hwp)
                    for mp, o in zip(rounded, new_orders):
                        mp.order = o
                    orders = torch.as_tensor(new_orders, device=device)
                rec.record(rounded)
                # Continue GD from the rounded point, fresh momentum.
                theta = _theta_tensor(
                    theta_from_mappings(rounded, cspec.free_mask), device)
                m_t = torch.zeros_like(theta)
                v_t = torch.zeros_like(theta)
                t = 0

    return rec.finish()


def _population_inputs(chunk: list[list[Mapping]], cspec: CompiledSpec,
                       device) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, orders) of a population chunk, on `device`."""
    theta = _theta_tensor(theta_from_population(chunk, cspec.free_mask),
                          device)
    orders = torch.as_tensor(orders_from_population(chunk), device=device)
    return theta, orders


def _dosa_search_batched(workload: Workload, cfg: SearchConfig,
                         population: int,
                         device: torch.device) -> SearchResult:
    """Host-batched engine: each GD segment of a population chunk runs
    on the device (`_adam_segment` over the batched loss); at every
    rounding point the chunk comes back to the host, is rounded there
    (`round_population`), re-selects its orderings (one batched device
    table, then coordinate descent) and is oracle-evaluated member by
    member.  A ragged final chunk is padded to `population` with
    replicas of its last member and the padding is masked out of the
    accounting, as in the reference."""
    cspec = _cspec(cfg)
    grad_fn, dims_t, strides_t, repeats_t = make_population_runner(
        workload, cfg, device)
    dims = workload.dims_array()
    free_mask_t = cspec.free_mask_t(device)
    pe_cap = int(_pe_cap(cfg, cspec))
    hw_fixed = _fixed_spec_hw(cfg, cspec, device)
    rec = _Recorder(workload, cfg, cspec)
    starts = _start_points(workload, cfg, rec)
    segments = _segment_lengths(cfg.steps, cfg.round_every)

    tracer = _obs.get_tracer()
    for lo in range(0, len(starts), population):
        chunk = starts[lo:lo + population]
        n_real = len(chunk)
        for mappings in chunk:
            rec.record(mappings)
        chunk = chunk + [chunk[-1]] * (population - n_real)
        P = len(chunk)
        theta, orders = _population_inputs(chunk, cspec, device)
        for seg, n_steps in enumerate(segments):
            with tracer.span("search.gd_segment", segment=seg,
                             n_steps=n_steps, population=P):
                theta = _adam_segment(grad_fn, cfg.lr, theta, orders,
                                      n_steps)
                rec.count(n_steps * n_real)  # one sample per GD step
            with tracer.span("search.rounding", segment=seg):
                f_cont = build_f(theta, dims_t, free_mask_t).cpu().numpy()
                rounded_pop = round_population(
                    f_cont, orders.cpu().numpy(), dims, pe_cap=pe_cap,
                    spec=cspec)
            if cfg.ordering_mode in ("iterative", "softmax"):
                with tracer.span("search.ordering", segment=seg):
                    fs_pop = torch.from_numpy(np.stack(
                        [stack_mappings(ms)[0] for ms in rounded_pop]
                    ).astype(np.float32)).to(device)
                    hws = _population_hw(cspec, fs_pop, strides_t,
                                         hw_fixed)
                    new_orders = select_orderings_population_spec(
                        cspec, fs_pop, strides_t, repeats_t, hws)
                    for ms, no in zip(rounded_pop, new_orders):
                        for mp, o in zip(ms, no):
                            mp.order = o
            with tracer.span("search.oracle", segment=seg):
                for ms in rounded_pop[:n_real]:
                    rec.record(ms)
            # Continue GD from the rounded points, fresh momentum.
            theta, orders = _population_inputs(rounded_pop, cspec, device)

    return rec.finish()


def _dosa_search_fused(workload: Workload, cfg: SearchConfig,
                       population: int, device,
                       chunk_uniforms: Callable | None = None
                       ) -> SearchResult:
    """Fused driver: per population chunk the device runs every GD
    segment, rounding and ordering re-selection (`FusedEngine.run`),
    and the host reads the per-segment rounded candidates back once.
    Oracle accounting then replays over the read-back in the
    reference's host-batched order.  A ragged final chunk is padded to
    `population` with replicas of its last member (per-member ops make
    the padding inert) and the padding is masked out of the
    accounting.

    The population axis is sharded over the "pop" mesh of the devices
    `device` names (`cfg.shards`; auto-resolved by default): each
    chunk starts on the first device and runs split over the mesh
    (`run_fused`), with every reported number bit-identical at any
    shard count.

    `cfg.start_points` in {"random-device", "cosa-device"} seeds each
    chunk on the device (`mapping.seed_population`, uniforms from
    `chunk_generator(cfg.seed, lo)`) instead of the host CoSA protocol;
    `chunk_uniforms(lo, population) -> (u_f, u_o)`, when given, supplies
    each chunk's uniforms instead (tests hand in the reference's)."""
    cspec = _cspec(cfg)
    devices = resolve_devices(device)
    device = devices[0]
    shards = auto_pop_shards(population, cfg.shards, devices)
    mesh = make_pop_mesh(shards, devices)
    engines = fused_engines(workload, cfg, mesh)
    rec = _Recorder(workload, cfg, cspec)
    device_seeded = cfg.start_points != "cosa"
    tracer = _obs.get_tracer()
    starts = []
    if not device_seeded:
        with tracer.span("search.starts", n=cfg.n_start_points):
            starts = _start_points(workload, cfg, rec)
    seg_lens = _segment_lengths(cfg.steps, cfg.round_every)
    n_full, rem = divmod(cfg.steps, cfg.round_every)

    for lo in range(0, cfg.n_start_points, population):
        n_real = min(population, cfg.n_start_points - lo)
        if device_seeded:
            from .mapping import seed_population
            mode = ("cosa" if cfg.start_points == "cosa-device"
                    else "random")
            uniforms = None if chunk_uniforms is None \
                else chunk_uniforms(lo, population)
            gen = None if uniforms is not None \
                else chunk_generator(cfg.seed, lo, device)
            _, theta, orders = seed_population(
                workload.dims_array(), population, gen, spec=cspec,
                pe_cap=int(_pe_cap(cfg, cspec)), mode=mode, device=device,
                uniforms=uniforms)
        else:
            chunk = starts[lo:lo + population]
            for mappings in chunk:
                rec.record(mappings)
            chunk = chunk + [chunk[-1]] * (population - n_real)
            theta, orders = _population_inputs(chunk, cspec, device)
        # The device work is enqueued here and drains inside the
        # read-back span below, where the copy to the host waits for it.
        with tracer.span("search.fused_dispatch", chunk=lo,
                         population=population, shards=shards,
                         n_full=n_full, rem=rem):
            (f_seg, o_seg, _), _best = run_fused(
                engines, mesh, (theta, orders),
                (member_spec(4), member_spec(2)), n_full=n_full, rem=rem,
                seg_len=cfg.round_every)

        # ---- the chunk's one read-back + oracle replay (padding skipped)
        with tracer.span("search.readback", chunk=lo):
            f_seg = f_seg.cpu().numpy().astype(float)  # (S, P, L, 2, nl, 7)
            o_seg = o_seg.cpu().numpy()                # (S, P, L, n_levels)
        for s, n_steps in enumerate(seg_lens):
            with tracer.span("search.oracle", segment=s, chunk=lo):
                rec.count(n_steps * n_real)  # one sample per GD step
                for p in range(n_real):
                    rec.record(unstack_mappings(f_seg[s, p], o_seg[s, p]))

    return rec.finish()
