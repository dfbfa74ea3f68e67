"""Fleet co-search: one run over a *portfolio* of ArchSpec targets.

The PyTorch port of `repro.core.fleet`.  `dosa_search` optimizes one
accelerator spec at a time; the fleet driver co-searches a workload
portfolio across several `ArchSpec`s in one run and reports the Pareto
frontier of targets x workloads.

Engine sharing
--------------
Specs are grouped by `archspec.engine_group_key`, the *structural*
fingerprint of the model (hierarchy depth, tensor -> level chains,
spatial sites, level-0 temporal dims).  All specs in a group share the
(2, n_levels, 7) mapping tensor shape, the GD free mask and the
ordering tables, so their start populations are stacked into ONE
member axis and advanced by ONE engine on the device, whose numeric
spec constants (EPA models, bandwidth coefficients, word sizes, PE
caps, fixed/searched capacities) arrive as per-member `SpecParams`
tensors.  TPU v5e and the 3-level edge spec share one engine;
Gemmini's 4-level hierarchy has its own.  The fused fleet engine
(`make_fused_fleet_runner`) runs every segment of a group on the
device: GD through the shared parametric loss, then rounding and
ordering re-selection per spec span with each spec's own tables.
With ``SearchConfig.shards`` > 1 (auto-resolved over the devices the
caller names) the member axis is split over the "pop" mesh: members
are permuted to shard-major order, so every shard holds n/shards
starts of every spec and its per-spec spans stay local, and the
read-back is permuted back — bit-identical to one shard.

Calibrated targets (``SearchConfig.surrogate = {spec_name:
TrainedModel}``) descend through their learned latency model instead:
those specs run their own single-target fused engine while uncovered
specs keep the shared group engine.

The per-member parametric model mirrors `model.layer_metrics_spec` /
`model.infer_hw_spec` with the spec's Python-branching evaluators
replaced by masked tensor arithmetic; unconstrained levels carry a
large finite capacity sentinel (`_BIG`) instead of +inf so ``slope *
kb`` stays exactly 0.0 rather than NaN.  It is written over leading
batch dims, as the port's `model.py` is: one call evaluates a whole
member axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, resolve_devices
from ..launch.mesh import auto_pop_shards, make_pop_mesh
from ..obs import telemetry as _obs
from ..sharding.rules import member_spec
from .archspec import (ArchSpec, CompiledSpec, engine_group_key,
                       resolve_spec)
from .lru import LRUCache
from .mapping import stack_mappings, unstack_mappings
from .model import (_prod_all, capacities, infer_hw_spec, layer_c_pe_spec,
                    population_best_init, population_best_update,
                    population_edp_spec, relu, traffic_spec, utilized_pes,
                    validity_penalty)
from .oracle import evaluate_workload
from .problem import Workload
from .rounding import (round_population, rounding_tables,
                       _round_population_core)
from .search import (_Recorder, _adam_segment, _generate_start_point,
                     _loss_grad, _population_choice, _segment_lengths,
                     _spatial_cap_penalty, _theta_tensor, SearchConfig,
                     SearchResult, build_f, dosa_search,
                     orders_from_population, run_fused,
                     select_orderings_population_spec,
                     theta_from_population)

# Capacity sentinel for unconstrained levels.  Finite on purpose: the
# level's EPA slope is 0, so `slope * (BIG * word_bytes / 1024)` is
# exactly 0.0, and capacity-overflow ratios `req / BIG` vanish — no
# NaN-through-`where` gradient hazards, unlike +inf.
_BIG = 1e30

_BW_KIND = {"const": 0.0, "pe_sqrt": 1.0, "pe_linear": 2.0}


class SpecParams(NamedTuple):
    """The numeric half of a compiled spec — what distinguishes
    same-group specs inside the shared fleet engine.  `spec_params`
    gives numpy leaves; `stack_spec_params` a member axis of float32
    tensors ((M, n_levels) / (M,))."""

    epa_base: object       # (n_levels,) pJ/word
    epa_slope: object      # (n_levels,) pJ/word per KB
    epa_pe_scaled: object  # (n_levels,) 1.0 => slope / sqrt(C_PE)
    bw_coeff: object       # (n_levels,)
    bw_kind: object        # (n_levels,) 0 const | 1 sqrt | 2 linear
    word_bytes: object     # (n_levels,)
    cap_fixed: object      # (n_levels,) fixed capacity words, _BIG else
    searched: object       # (n_levels,) 1.0 => capacity inferred
    epa_mac: object        # () pJ/MAC
    pe_cap: object         # () PE-array side bound
    pe_fixed: object       # () 1.0 => side pinned to pe_cap (silicon)


# Fields with a level axis; the rest are per-member scalars.
_LEVEL_FIELDS = frozenset(SpecParams._fields[:8])


def spec_params(spec) -> SpecParams:
    """Lower one spec's numeric tables to a `SpecParams` (host numpy)."""
    cspec = resolve_spec(spec)
    s = cspec.spec
    nl = cspec.n_levels
    cap_fixed = np.full(nl, _BIG)
    for (i, words) in cspec.fixed_capacity:
        cap_fixed[i] = words
    searched = np.zeros(nl)
    for i in cspec.searched_levels:
        searched[i] = 1.0
    return SpecParams(
        epa_base=np.array([lvl.epa.base for lvl in s.levels]),
        epa_slope=np.array([lvl.epa.slope for lvl in s.levels]),
        epa_pe_scaled=np.array(
            [float(lvl.epa.pe_scaled) for lvl in s.levels]),
        bw_coeff=np.array([lvl.bandwidth.coeff for lvl in s.levels]),
        bw_kind=np.array(
            [_BW_KIND[lvl.bandwidth.kind] for lvl in s.levels]),
        word_bytes=np.asarray(cspec.word_bytes, dtype=float),
        cap_fixed=cap_fixed,
        searched=searched,
        epa_mac=np.asarray(float(s.epa_mac)),
        pe_cap=np.asarray(float(cspec.pe_cap)),
        pe_fixed=np.asarray(float(s.fixed_pe_dim is not None)))


def stack_spec_params(params: list[SpecParams],
                      device=DEFAULT_DEVICE) -> SpecParams:
    """One (M, ...) member axis of float32 tensors on `device` from a
    list of per-member params."""
    dev = resolve_device(device)
    return SpecParams(*(
        torch.from_numpy(np.stack(xs).astype(np.float32)).to(dev)
        for xs in zip(*params)))


def _per_layer(sp: SpecParams) -> SpecParams:
    """`sp` with a layer axis inserted before its level axis (or at the
    end of a scalar leaf), to broadcast against (..., L, n_levels)."""
    return SpecParams(*(x[..., None, :] if f in _LEVEL_FIELDS
                        else x[..., None]
                        for f, x in zip(SpecParams._fields, sp)))


# ---------------------------------------------------------------------------
# Parametric model pieces, batched over leading dims.  They mirror
# model.layer_metrics_spec / infer_hw_spec with the compiled spec's
# Python-branching EPA/bandwidth evaluators replaced by masked tensor
# arithmetic over SpecParams.
# ---------------------------------------------------------------------------

def _epa_param(sp: SpecParams, c_pe, cap_words):
    """(..., n_levels) energy/access: base + slope * KB [/ sqrt(C_PE)];
    c_pe (...), cap_words and sp's level leaves (..., n_levels)."""
    kb = cap_words * sp.word_bytes / 1024.0
    denom = torch.where(sp.epa_pe_scaled > 0.0, c_pe[..., None] ** 0.5,
                        1.0)
    return sp.epa_base + sp.epa_slope * kb / denom


def _bw_param(sp: SpecParams, c_pe):
    """(..., n_levels) words/cycle: coeff * {1, sqrt(C_PE), C_PE}."""
    c = c_pe[..., None]
    scale = torch.where(sp.bw_kind > 1.5, c,
                        torch.where(sp.bw_kind > 0.5, c ** 0.5, 1.0))
    return sp.bw_coeff * scale


def _infer_hw_param(group: CompiledSpec, sp: SpecParams, f_all, strides,
                    b_mat):
    """Mapping-first minimal hardware (Eq. 1 / Fig. 3), parametric in
    the member's searched/fixed pattern and PE bound.  f_all (..., L, 2,
    n_levels, 7); returns (c_pe (...), cap_words (..., n_levels))."""
    caps = capacities(f_all, strides)                  # (..., L, nl, 3)
    req = torch.amax((caps * b_mat).sum(dim=-1), dim=-2)
    c_pe_free = torch.minimum(
        torch.amax(layer_c_pe_spec(group, f_all), dim=-1), sp.pe_cap ** 2)
    c_pe = torch.where(sp.pe_fixed > 0.0, sp.pe_cap ** 2, c_pe_free)
    cap_words = torch.where(sp.searched > 0.0, req, sp.cap_fixed)
    return c_pe, cap_words


def _layer_el_param(group: CompiledSpec, sp: SpecParams, f, order, strides,
                    c_pe, cap_words):
    """(energy, latency) of layer mappings — layer_metrics_spec with the
    EPA/bandwidth models read from SpecParams (leaves broadcast against
    f's batch dims)."""
    caps = capacities(f, strides)
    macs = _prod_all(f, 3)
    tr = traffic_spec(group, f, order, caps, macs)
    mem_lat = tr.accesses / _bw_param(sp, c_pe)
    latency = torch.maximum(macs / utilized_pes(f),
                            torch.amax(mem_lat, dim=-1))
    epa = _epa_param(sp, c_pe, cap_words)
    energy = macs * sp.epa_mac
    for i in range(group.n_levels):
        energy = energy + tr.accesses[..., i] * epa[..., i]
    return energy, latency


def _b_mat(group: CompiledSpec, device) -> torch.Tensor:
    """The (n_levels, 3) tensor-binding matrix as float32 on `device`."""
    return torch.from_numpy(group.b_matrix.astype(np.float32)).to(device)


def member_edp(group: CompiledSpec, sp: SpecParams, f_all, orders, strides,
               repeats, b_mat=None):
    """Network EDP (Eq. 14) of members' workload mappings under their
    own spec parameters, hardware inferred mapping-first.  f_all (...,
    L, 2, n_levels, 7), orders (..., L, n_levels); sp leaves (...,
    n_levels) / (...).  Returns (...).  The engines pass `b_mat`
    (`_b_mat`) built once, so no step copies it to the device."""
    if b_mat is None:
        b_mat = _b_mat(group, f_all.device)
    c_pe, cap_words = _infer_hw_param(group, sp, f_all, strides, b_mat)
    e, lat = _layer_el_param(group, _per_layer(sp), f_all, orders, strides,
                             c_pe[..., None], cap_words[..., None, :])
    return (e * repeats).sum(dim=-1) * (lat * repeats).sum(dim=-1)


# ---------------------------------------------------------------------------
# The shared engines, cached per (workload, structural group, device), so
# every same-group spec — and every later fleet run over the same
# workload — reuses them.
# ---------------------------------------------------------------------------

# Bounded LRU with eviction accounting (see `lru.LRUCache`): the serving
# layer keeps a long-lived process around, so the fleet engine cache
# must not grow without limit either.
_FLEET_ENGINE_CACHE = LRUCache(maxsize=16)


def fleet_engine_cache_stats() -> dict:
    return _FLEET_ENGINE_CACHE.stats()


def fleet_engine_key(workload: Workload, spec, cfg: SearchConfig,
                     device=DEFAULT_DEVICE) -> tuple:
    """Cache key of the shared fleet engine: structural group + the
    config fields the engine reads + the device."""
    return (workload, engine_group_key(spec), cfg.lr, cfg.penalty_weight,
            str(device))


def _fleet_loss_fn(workload: Workload, group: CompiledSpec,
                   cfg: SearchConfig, device):
    """The member-parametric GD loss shared by the segment-runner and
    fused fleet engines: `loss(theta, orders, sp)` evaluates each
    member's log-EDP + penalties under its own `SpecParams`, (...)."""
    dims = torch.as_tensor(workload.dims_array().astype(np.float32),
                           device=device)
    strides = torch.as_tensor(workload.strides_array().astype(np.float32),
                              device=device)
    repeats = torch.as_tensor(workload.repeats_array().astype(np.float32),
                              device=device)
    free_mask = group.free_mask_t(device)
    sites = group.spatial_sites
    b_mat = _b_mat(group, device)
    penalty_weight = cfg.penalty_weight

    def loss(theta, orders, sp: SpecParams):
        f = build_f(theta, dims, free_mask)
        edp = member_edp(group, sp, f, orders, strides, repeats, b_mat)
        pen = validity_penalty(f) \
            + _spatial_cap_penalty(f, sp.pe_cap[..., None, None], sites)
        # Fixed-silicon capacity overflow (e.g. TPU VMEM): unconstrained
        # and searched levels carry the _BIG sentinel => zero penalty.
        req = (capacities(f, strides) * b_mat).sum(dim=-1)  # (..., L, nl)
        pen = pen + relu(req / sp.cap_fixed[..., None, :] - 1.0).sum(
            dim=(-2, -1))
        return torch.log(edp) + penalty_weight * pen

    return loss, dims, strides, repeats


def _member_grad(loss) -> Callable:
    """(theta, orders, sp) -> per-member gradient of `loss`."""
    def grad(theta, orders, sp):
        return _loss_grad(lambda th, o: loss(th, o, sp))(theta, orders)
    return grad


def shard_major_order(n: int, n_specs: int, shards: int) -> np.ndarray:
    """The member permutation that puts a spec-major group (`n` starts
    of each of `n_specs` specs) in shard-major order: shard i's block
    holds n/shards starts of every spec, spec-major within it."""
    b = n // shards
    return np.array([s_i * n + i * b + j for i in range(shards)
                     for s_i in range(n_specs) for j in range(b)])


def make_fleet_runner(workload: Workload, spec, cfg: SearchConfig,
                      device=DEFAULT_DEVICE) -> Callable:
    """The fleet GD engine of `spec`'s structural group on `device`,
    built or fetched from the cache: ``run_segment(theta, orders,
    params, n_steps=...)`` advances an (M, L, 2, n_levels, 7) member
    population by `n_steps` Adam steps over the member-parametric loss,
    `params` a stacked `SpecParams`.  Two specs with equal
    `engine_group_key` share one engine (the same cache entry)."""
    dev = resolve_device(device)
    key = fleet_engine_key(workload, spec, cfg, dev)
    hit = _FLEET_ENGINE_CACHE.get(key)
    if hit is not None:
        return hit

    def build():
        group = resolve_spec(spec)   # structural representative
        grad = _member_grad(_fleet_loss_fn(workload, group, cfg, dev)[0])

        def run_segment(theta, orders, params, *, n_steps: int):
            return _adam_segment(lambda th, o: grad(th, o, params),
                                 cfg.lr, theta, orders, n_steps)
        return run_segment

    label = f"segment:{workload.name}"
    value, build_s = _obs.profile_build(build, kind="segment",
                                        cache="fleet", label=label)
    _FLEET_ENGINE_CACHE.note_build_time(label, build_s)
    _FLEET_ENGINE_CACHE.put(key, value)
    return value


@dataclasses.dataclass
class FusedFleetEngine:
    """The device-resident fleet engine of one structural group: the
    single-target fused segment lifted to a stacked member axis.  GD
    runs the shared parametric loss (per-member `SpecParams`); rounding
    and ordering re-selection run per spec span, each projected and
    re-ordered with its own compiled spec, so members never leave the
    device between segments.  The member axis holds the same number of
    starts of every spec, spec-major: the whole group's, or one pop
    shard's block of it."""

    cspecs: list
    cfg: SearchConfig
    grad_fn: Callable
    dims: torch.Tensor
    strides: torch.Tensor
    repeats: torch.Tensor
    tables: object
    free_mask: torch.Tensor
    combos: torch.Tensor

    def segment(self, theta, orders, sp_stack, best, n_steps: int):
        """Adam -> per-spec rounding -> ordering CD -> best tracking."""
        cfg = self.cfg
        n = theta.shape[0] // len(self.cspecs)     # starts per spec
        theta = _adam_segment(
            lambda th, o: self.grad_fn(th, o, sp_stack), cfg.lr, theta,
            orders, n_steps)
        with torch.no_grad():
            f_cont = build_f(theta, self.dims, self.free_mask)
            f_parts, th_parts, o_parts, edp_parts = [], [], [], []
            for i, cspec in enumerate(self.cspecs):
                a, b = i * n, (i + 1) * n
                f_r, th_r = _round_population_core(cspec, self.tables,
                                                   f_cont[a:b],
                                                   cspec.pe_cap)
                if cfg.ordering_mode == "iterative":
                    hws = infer_hw_spec(cspec, f_r, self.strides)
                    o_r = self.combos[_population_choice(
                        cspec, f_r, self.strides, self.repeats, hws)]
                else:
                    o_r = orders[a:b]
                edp_parts.append(population_edp_spec(
                    cspec, f_r, o_r, self.strides, self.repeats))
                f_parts.append(f_r)
                th_parts.append(th_r)
                o_parts.append(o_r)
            f_round = torch.cat(f_parts)
            theta = torch.cat(th_parts)
            orders = torch.cat(o_parts)
            edp = torch.cat(edp_parts)
            best = population_best_update(best, edp, f_round, orders)
        return theta, orders, best, (f_round, orders, edp)

    def run(self, theta, orders, sp_stack, *, n_full: int, rem: int,
            seg_len: int):
        """Advance the group's members through `n_full` segments of
        `seg_len` GD steps plus an optional `rem`-step tail.  Returns
        ``((f_rounded, orders, model_edp), best)`` with a leading
        per-segment axis on the first tuple, all on the device."""
        best = population_best_init(theta, orders)
        outs = []
        for n_steps in [seg_len] * n_full + ([rem] if rem else []):
            theta, orders, best, out = self.segment(theta, orders, sp_stack,
                                                    best, n_steps)
            outs.append(out)
        ys = tuple(torch.stack(parts) for parts in zip(*outs))
        return ys, best


def make_fused_fleet_runner(workload: Workload, specs: list[ArchSpec],
                            cfg: SearchConfig,
                            device=DEFAULT_DEVICE) -> FusedFleetEngine:
    """The fused fleet engine of one structural group on `device`,
    cached per (workload, spec tuple, start count, the config fields it
    reads, device)."""
    dev = resolve_device(device)
    key = (workload, "fused", tuple(specs), cfg.n_start_points, cfg.lr,
           cfg.penalty_weight, cfg.ordering_mode, str(dev))
    hit = _FLEET_ENGINE_CACHE.get(key)
    if hit is not None:
        return hit
    # Cache miss: the whole construction runs under one engine.build
    # span (closed just before the put at the end).
    token = _obs.start_build(kind="fused", cache="fleet",
                             label=f"fused:{workload.name}")
    group = resolve_spec(specs[0])
    loss, dims, strides, repeats = _fleet_loss_fn(workload, group, cfg, dev)
    engine = FusedFleetEngine(
        cspecs=[resolve_spec(s) for s in specs], cfg=cfg,
        grad_fn=_member_grad(loss), dims=dims, strides=strides,
        repeats=repeats, tables=rounding_tables(workload.dims_array(), dev),
        free_mask=group.free_mask_t(dev),
        combos=group.device_tables(dev)["combos"])
    _FLEET_ENGINE_CACHE.note_build_time(f"fused:{workload.name}",
                                        _obs.finish_build(token))
    _FLEET_ENGINE_CACHE.put(key, engine)
    return engine


# ---------------------------------------------------------------------------
# Results: per-(spec, workload) bests + the Pareto frontier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetEntry:
    """Best point found for one (spec, workload) pair."""

    spec_name: str
    workload: str
    best_edp: float
    best_energy: float          # pJ, repeat-scaled network total
    best_latency: float         # cycles, repeat-scaled network total
    best_hw: object             # GemminiHW | HWConfig
    best_mappings: list
    n_evals: int
    start_edps: list[float]
    # (cumulative evals, best oracle EDP) trace of this target's search
    # — the same shape SearchResult.history carries.
    history: list[tuple[int, float]] = dataclasses.field(
        default_factory=list)


def _dominates(a: FleetEntry, b: FleetEntry) -> bool:
    """a dominates b in (energy, latency) minimization."""
    return (a.best_energy <= b.best_energy
            and a.best_latency <= b.best_latency
            and (a.best_energy < b.best_energy
                 or a.best_latency < b.best_latency))


def pareto_front(entries: list[FleetEntry]) -> list[FleetEntry]:
    """Non-dominated subset of `entries` in (energy, latency)."""
    return [e for e in entries
            if not any(_dominates(o, e) for o in entries if o is not e)]


@dataclasses.dataclass
class FleetResult:
    """Structured fleet output: one `FleetEntry` per (spec, workload),
    plus Pareto reporting over the portfolio.  Answers `best_edp`,
    `history` and `n_evals` as a `SearchResult` does."""

    entries: list[FleetEntry]

    @property
    def best_edp(self) -> float:
        """Lowest EDP over the whole portfolio (a summary statistic;
        per-target bests are on the entries)."""
        return min((e.best_edp for e in self.entries),
                   default=float("inf"))

    @property
    def n_evals(self) -> int:
        return sum(e.n_evals for e in self.entries)

    @property
    def history(self) -> list[tuple[int, float]]:
        """(cumulative evals, running best EDP) over the entries in
        order — the fleet-level analogue of SearchResult.history."""
        out: list[tuple[int, float]] = []
        offset, best = 0, float("inf")
        for e in self.entries:
            for (ev, edp) in e.history:
                best = min(best, edp)
                out.append((offset + ev, best))
            offset += e.n_evals
        return out

    def entry(self, spec_name: str, workload: str) -> FleetEntry:
        for e in self.entries:
            if e.spec_name == spec_name and e.workload == workload:
                return e
        raise KeyError(f"no fleet entry ({spec_name}, {workload})")

    def frontier(self, workload: str | None = None) -> list[FleetEntry]:
        """The Pareto frontier over targets x workloads in (energy,
        latency).  Targets are compared on the same workload: `workload`
        selects one workload's frontier; the default unions the
        per-workload frontiers in entry order."""
        if workload is not None:
            return pareto_front([e for e in self.entries
                                 if e.workload == workload])
        out: list[FleetEntry] = []
        for wl in dict.fromkeys(e.workload for e in self.entries):
            out.extend(self.frontier(wl))
        return out

    def to_csv(self) -> str:
        """CSV of every (spec, workload) best with an `on_frontier`
        flag — the benchmark artifact format."""
        front = {id(e) for e in self.frontier()}
        lines = ["spec,workload,edp,energy_pj,latency_cycles,pe_dim,"
                 "cap_kb,n_evals,on_frontier"]
        for e in self.entries:
            caps = "|".join(f"{kb:g}" for kb in _entry_cap_kbs(e))
            lines.append(
                f"{e.spec_name},{e.workload},{e.best_edp:.6e},"
                f"{e.best_energy:.6e},{e.best_latency:.6e},"
                f"{e.best_hw.pe_dim},{caps},{e.n_evals},"
                f"{int(id(e) in front)}")
        return "\n".join(lines) + "\n"


def _entry_cap_kbs(e: FleetEntry) -> tuple:
    hw = e.best_hw
    return tuple(hw.cap_kb) if hasattr(hw, "cap_kb") \
        else (hw.acc_kb, hw.sp_kb)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _check_cfg(cfg: SearchConfig) -> None:
    if cfg.spec is not None:
        raise ValueError("fleet_search takes the spec portfolio as its "
                         "own argument; leave SearchConfig.spec unset")
    if cfg.surrogate is not None and not isinstance(cfg.surrogate, dict):
        raise ValueError(
            "fleet surrogates are per-target: pass a dict mapping spec "
            "name -> TrainedModel (calibrate each spec with "
            "core.calibration.calibrate), not a single model — feature "
            "widths differ across specs")
    if cfg.fixed_hw is not None or cfg.latency_model is not None:
        raise ValueError("fleet_search co-searches hardware per target; "
                         "fixed_hw / latency_model are not supported")
    if cfg.ordering_mode not in ("iterative", "none"):
        raise ValueError(f"fleet ordering_mode must be 'iterative' or "
                         f"'none', got {cfg.ordering_mode!r} (softmax "
                         "ordering runs per-spec via dosa_search)")


_TRACED_CFG_FIELDS = ("lr", "penalty_weight", "ordering_mode",
                      "softmax_temp", "steps", "round_every",
                      "n_start_points")


def search_group_results(workload: Workload, specs: list[ArchSpec],
                         cfg: SearchConfig, fused: bool = True,
                         cfgs: list[SearchConfig] | None = None,
                         device=DEFAULT_DEVICE) -> list[SearchResult]:
    """Co-search one structural group on `device` and return the
    per-spec `SearchResult`s: every spec's start population is stacked
    into one member axis and advanced by the shared engine.  With
    `fused=True` (default) the whole segment loop runs on the device
    (`make_fused_fleet_runner`) and the host replays rounding-point
    oracle accounting from the final read-back; with `fused=False`
    rounding / ordering re-selection / oracle accounting run per spec
    between GD segments on the host.

    `cfgs` optionally carries one config per member for the host-side
    protocol (start-point seeds, budget accounting) — the serving layer
    batches same-structure requests with different seeds this way.
    Fields the engine reads must agree with `cfg`, since all members
    share its engine.  `device` may name several devices: the fused
    engine's pop mesh (`cfg.shards`, auto-resolved over them); the
    host-batched form runs on the first."""
    if cfgs is not None:
        if len(cfgs) != len(specs):
            raise ValueError(f"{len(cfgs)} configs for {len(specs)} specs")
        for c in cfgs:
            bad = [f for f in _TRACED_CFG_FIELDS
                   if getattr(c, f) != getattr(cfg, f)]
            if bad:
                raise ValueError(
                    f"per-member config disagrees with the shared engine "
                    f"config on traced/protocol fields {bad}")
    devices = resolve_devices(device)
    dev = devices[0]
    run_segment = None if fused else make_fleet_runner(workload, specs[0],
                                                       cfg, dev)
    group = resolve_spec(specs[0])
    dims = workload.dims_array()
    dims_t = torch.as_tensor(dims.astype(np.float32), device=dev)
    strides_t = torch.as_tensor(
        workload.strides_array().astype(np.float32), device=dev)
    repeats_t = torch.as_tensor(
        workload.repeats_array().astype(np.float32), device=dev)
    free_mask_t = group.free_mask_t(dev)

    # --- per-spec start populations (per-spec RNG streams seeded like
    # dosa_search, so fleet starts match single-target runs), stacked
    # into one member axis.  Every start is validated against its own
    # target.
    recs: list[_Recorder] = []
    cspecs: list[CompiledSpec] = []
    spans: list[tuple[int, int]] = []
    thetas, orders_np, params = [], [], []
    lo = 0
    for i, spec in enumerate(specs):
        cspec = resolve_spec(spec)
        scfg = dataclasses.replace(cfg if cfgs is None else cfgs[i],
                                   spec=spec)
        rec = _Recorder(workload, scfg, cspec)
        rng = np.random.default_rng(scfg.seed)
        starts, best_start_edp = [], float("inf")
        for _ in range(cfg.n_start_points):
            mappings, edp0, best_start_edp = _generate_start_point(
                workload, scfg, rng, best_start_edp, rec)
            for m, drow in zip(mappings, dims):
                m.validate(drow, spec=cspec)
            rec.best.start_edps.append(edp0)
            rec.record(mappings)
            starts.append(mappings)
        thetas.append(theta_from_population(starts, cspec.free_mask))
        orders_np.append(orders_from_population(starts))
        params += [spec_params(cspec)] * len(starts)
        recs.append(rec)
        cspecs.append(cspec)
        spans.append((lo, lo + len(starts)))
        lo += len(starts)

    theta = _theta_tensor(np.concatenate(thetas), dev)
    orders = torch.as_tensor(np.concatenate(orders_np), device=dev)
    sp_stack = stack_spec_params(params, dev)
    seg_lens = _segment_lengths(cfg.steps, cfg.round_every)

    if fused:
        # ---- the whole group's segment loop on the device; oracle
        # accounting replays from the final read-back in the
        # host-batched order (per segment, per spec, per member).  With
        # shards > 1 the member axis is split over the "pop" mesh:
        # members permute to shard-major order (every shard gets
        # n/shards starts of each spec, keeping per-spec spans local)
        # and the read-back permutes back; per-member ops make the
        # permutation invisible, so results stay bit-identical.
        n = cfg.n_start_points
        shards = auto_pop_shards(n, cfg.shards, devices)
        mesh = make_pop_mesh(shards, devices)
        engines = {d: make_fused_fleet_runner(workload, specs, cfg, d)
                   for d in mesh.devices}
        n_full, rem = divmod(cfg.steps, cfg.round_every)
        tracer = _obs.get_tracer()
        with tracer.span("fleet.fused_dispatch", members=len(params),
                         specs=len(specs), shards=shards):
            inv = None
            if shards > 1:
                perm = shard_major_order(n, len(specs), shards)
                inv = np.argsort(perm)
                perm_t = torch.as_tensor(perm, device=dev)
                theta, orders = theta[perm_t], orders[perm_t]
                sp_stack = SpecParams(*(x[perm_t] for x in sp_stack))
            (f_seg, o_seg, _), _best = run_fused(
                engines, mesh, (theta, orders, sp_stack),
                (member_spec(4), member_spec(2), member_spec()),
                n_full=n_full, rem=rem, seg_len=cfg.round_every)
        with tracer.span("fleet.readback"):
            f_seg = f_seg.cpu().numpy().astype(float)
            o_seg = o_seg.cpu().numpy()
            if inv is not None:
                f_seg, o_seg = f_seg[:, inv], o_seg[:, inv]
        for s, n_steps in enumerate(seg_lens):
            with tracer.span("fleet.oracle", segment=s):
                for rec, (a, b) in zip(recs, spans):
                    rec.count(n_steps * (b - a))
                    for p in range(a, b):
                        rec.record(
                            unstack_mappings(f_seg[s, p], o_seg[s, p]))
    else:
        for n_steps in seg_lens:
            theta = run_segment(theta, orders, sp_stack, n_steps=n_steps)
            f_cont = build_f(theta, dims_t, free_mask_t).cpu().numpy()
            orders_host = orders.cpu().numpy()
            new_thetas, new_orders = [], []
            for cspec, rec, (a, b) in zip(cspecs, recs, spans):
                rec.count(n_steps * (b - a))
                rounded = round_population(f_cont[a:b], orders_host[a:b],
                                           dims, spec=cspec)
                if cfg.ordering_mode == "iterative":
                    fs_pop = torch.from_numpy(np.stack(
                        [stack_mappings(ms)[0] for ms in rounded]
                    ).astype(np.float32)).to(dev)
                    hws = infer_hw_spec(cspec, fs_pop, strides_t)
                    sel = select_orderings_population_spec(
                        cspec, fs_pop, strides_t, repeats_t, hws)
                    for ms, no in zip(rounded, sel):
                        for mp, o in zip(ms, no):
                            mp.order = o
                for ms in rounded:
                    rec.record(ms)
                new_thetas.append(
                    theta_from_population(rounded, cspec.free_mask))
                new_orders.append(orders_from_population(rounded))
            theta = _theta_tensor(np.concatenate(new_thetas), dev)
            orders = torch.as_tensor(np.concatenate(new_orders), device=dev)

    return [rec.finish() for rec in recs]


def _search_group(workload: Workload, specs: list[ArchSpec],
                  cfg: SearchConfig, fused: bool,
                  device) -> list[FleetEntry]:
    """`search_group_results` wrapped into per-(spec, workload)
    `FleetEntry`s — the fleet_search driver path."""
    results = search_group_results(workload, specs, cfg, fused=fused,
                                   device=device)
    return [_fleet_entry(spec, resolve_spec(spec), workload, sr)
            for spec, sr in zip(specs, results)]


def _fleet_entry(spec: ArchSpec, cspec: CompiledSpec, workload: Workload,
                 sr) -> FleetEntry:
    """Wrap one spec's `SearchResult` into a `FleetEntry`, re-evaluating
    the best point through the per-spec oracle for the (energy, latency)
    Pareto axes."""
    if sr.best_mappings and np.isfinite(sr.best_edp):
        _, results = evaluate_workload(sr.best_mappings,
                                       workload.layers, spec=cspec)
        energy = sum(r.energy * layer.repeat
                     for r, layer in zip(results, workload.layers))
        latency = sum(r.latency * layer.repeat
                      for r, layer in zip(results, workload.layers))
    else:       # no valid candidate survived — report the degenerate point
        energy = latency = float("inf")
    return FleetEntry(
        spec_name=spec.name, workload=workload.name,
        best_edp=sr.best_edp, best_energy=float(energy),
        best_latency=float(latency), best_hw=sr.best_hw,
        best_mappings=sr.best_mappings, n_evals=sr.n_evals,
        start_edps=sr.start_edps, history=list(sr.history))


def _search_calibrated(workload: Workload, spec: ArchSpec,
                       cfg: SearchConfig, model, fused: bool,
                       device) -> list[FleetEntry]:
    """Co-search one spec through its calibrated latency model: a
    surrogate brings per-spec features and MLP weights into the loss,
    so calibrated targets run their own single-target engine instead of
    sharing the group's parametric one."""
    scfg = dataclasses.replace(cfg, spec=spec, surrogate=model)
    sr = dosa_search(workload, scfg, population=cfg.n_start_points,
                     fused=fused, device=device)
    return [_fleet_entry(spec, resolve_spec(spec), workload, sr)]


def fleet_search(workloads: Workload | Iterable[Workload],
                 specs: ArchSpec | Iterable[ArchSpec],
                 cfg: SearchConfig | None = None, fused: bool = True,
                 device=DEFAULT_DEVICE) -> FleetResult:
    """Co-search a workload portfolio across a set of ArchSpec targets
    in one run, on `device` (the card unless the caller asks for the
    CPU; a sequence of devices is the pop mesh the fused group engines
    shard their members over).  Specs are grouped by
    `engine_group_key`; each group's populations batch into one shared
    engine (numeric spec tables as per-member parameters), different
    groups run as separate cached engines.  `fused=False` is the
    host-batched form.  Returns a `FleetResult` of per-(spec, workload)
    bests and the Pareto frontier.  Routes through `api.run_request`,
    as the reference does."""
    from ..api import SearchRequest, run_request
    if isinstance(specs, ArchSpec):
        specs = [specs]
    return run_request(SearchRequest(
        workload=workloads, specs=tuple(specs),
        config=SearchConfig() if cfg is None else cfg,
        fused=fused, device=device)).result


def execute_fleet_search(workloads, specs, cfg: SearchConfig,
                         fused: bool = True,
                         device=DEFAULT_DEVICE) -> FleetResult:
    """Fleet dispatch shared by `fleet_search` and `api.run_request`."""
    _check_cfg(cfg)
    dev = resolve_devices(device)
    if isinstance(workloads, Workload):
        workloads = [workloads]
    if isinstance(specs, ArchSpec):
        specs = [specs]
    workloads, specs = list(workloads), list(specs)
    if not workloads or not specs:
        raise ValueError("fleet_search needs >= 1 workload and >= 1 spec")
    # Results are keyed (and Pareto-grouped) by name: duplicates would
    # silently pool non-commensurable workloads into one frontier or
    # alias two targets' entries — fail fast instead.
    wl_names = [w.name for w in workloads]
    spec_names = [s.name for s in specs]
    if len(set(wl_names)) != len(wl_names):
        raise ValueError(f"duplicate workload names in {wl_names}; give "
                         "each Workload a distinct name")
    if len(set(spec_names)) != len(spec_names):
        raise ValueError(f"duplicate spec names in {spec_names}; give "
                         "each ArchSpec a distinct name")

    surrogates = cfg.surrogate or {}
    unknown = set(surrogates) - set(spec_names)
    if unknown:
        raise ValueError(f"surrogates for unknown specs {sorted(unknown)}; "
                         f"portfolio has {spec_names}")

    entries: list[FleetEntry] = []
    for workload in workloads:
        groups: dict[tuple, list[ArchSpec]] = {}
        for spec in specs:
            if spec.name in surrogates:
                continue      # calibrated targets run their own engine
            groups.setdefault(engine_group_key(spec), []).append(spec)
        for group_specs in groups.values():
            entries.extend(_search_group(workload, group_specs, cfg,
                                         fused, dev))
        for spec in specs:
            if spec.name in surrogates:
                entries.extend(_search_calibrated(
                    workload, spec, cfg, surrogates[spec.name], fused,
                    dev))
    # Entry order: workload-major, then the caller's spec order.
    order = {(s.name, w.name): i for i, (w, s) in enumerate(
        (w, s) for w in workloads for s in specs)}
    entries.sort(key=lambda e: order[(e.spec_name, e.workload)])
    return FleetResult(entries=entries)
