"""ArchSpec: declarative accelerator specifications (paper Sec. 6.5).

The paper's modularity claim is that DOSA's differentiable model can be
retargeted to new hardware by swapping the architecture description.
This module makes that literal: an accelerator is *data* — an
`ArchSpec` of ordered memory levels (innermost first, backing store
last), a tensor-binding matrix B (which tensor lives at which level,
Table 4), per-level word sizes, energy-per-access models (constant or
capacity-dependent affine, Table 2), bandwidth models, the free spatial
sites of the dataflow, and which capacities are searched vs. fixed.

`compile_spec(spec)` lowers an `ArchSpec` into the static tables the
tensor model consumes:

* tensor -> storage-level chains (from B, innermost first),
* the `3**(n_levels-1)` loop-ordering combo table (Sec. 5.2),
* the free-parameter mask for gradient descent (Sec. 5.3.3),
* searched/fixed capacity bookkeeping and EPA/bandwidth evaluators.

Compiled specs are cached and hashed by identity, so engines built
against a spec stay cached.  This is the PyTorch port's own copy of
the reference module (`repro.core.archspec`), held to it table for
table by the port's tests.  Three targets ship here:

* `GEMMINI_SPEC`   — the paper's accelerator-under-study, built from the
  constants in `arch.py` (bit-for-bit the legacy model);
* `TPU_V5E_SPEC`   — the hardware-adaptation target: fixed silicon
  (128x128 MXU, fixed-capacity VMEM, HBM), mapping-only search;
* `EDGE_SPEC`      — a 3-level edge accelerator (shared SRAM), proving
  the model generalizes across hierarchy depths (9 ordering combos,
  not 27).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np

from .arch import (DRAM_BLOCK_WORDS, DRAM_BW, EPA_ACC_BASE, EPA_ACC_SLOPE,
                   EPA_DRAM, EPA_MAC, EPA_REG, EPA_SP_BASE, EPA_SP_SLOPE,
                   MAX_PE_DIM, SRAM_ROUND_BYTES, TPU_V5E)
from .problem import C, K, N, NTENSORS, P, Q, R, S, TENSORS

SPATIAL, TEMPORAL = 0, 1   # mirrors mapping.py (kept local to avoid a cycle)


# ---------------------------------------------------------------------------
# Spec building blocks (pure-python, hashable, frozen)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpaModel:
    """Energy per access in pJ/word: `base + slope * capacity_KB`,
    optionally divided by sqrt(C_PE) (Table 2's accumulator model).
    `slope == 0` is a constant-EPA level (registers, DRAM).

    `source` records where the coefficients came from: the shipped specs
    use Table-2 constants (`"table"`); `EpaModel.fit` (`"fitted"`)
    least-squares fits them to CACTI/Accelergy-style measurement
    samples (`core.calibration.calibrate_epa`), so a spec's energy
    numbers can come from measurement instead of paper constants."""

    base: float
    slope: float = 0.0
    pe_scaled: bool = False
    source: str = "table"

    def __call__(self, kb, c_pe=1.0):
        """Evaluate pJ/word at capacity `kb` (KB) and `c_pe` total PEs.
        Works with python scalars or numpy arrays."""
        denom = c_pe ** 0.5 if self.pe_scaled else 1.0
        return self.base + self.slope * kb / denom

    @classmethod
    def fit(cls, kb, c_pe, pj, pe_scaled: bool | None = None) -> "EpaModel":
        """Least-squares fit of (base, slope) to measured
        energy-per-access samples: `pj ~ base + slope * kb [/ sqrt(c_pe)]`.
        `pe_scaled=None` tries both scalings and keeps the lower-residual
        one.  Negative coefficients are clamped to zero and the remaining
        coefficient refit (EPA models are physically nonnegative)."""
        kb = np.asarray(kb, dtype=float)
        c_pe = np.broadcast_to(np.asarray(c_pe, dtype=float), kb.shape)
        pj = np.asarray(pj, dtype=float)
        if kb.shape != pj.shape:
            raise ValueError(f"kb {kb.shape} / pj {pj.shape} mismatch")

        def _fit_one(scaled: bool) -> tuple["EpaModel", float]:
            x = kb / np.sqrt(c_pe) if scaled else kb
            a = np.stack([np.ones_like(x), x], axis=1)
            (base, slope), *_ = np.linalg.lstsq(a, pj, rcond=None)
            if slope < 0.0:
                base, slope = float(np.mean(pj)), 0.0
            if base < 0.0:
                base = 0.0
                denom = float(np.sum(x * x))
                slope = float(np.sum(x * pj) / denom) if denom > 0 else 0.0
            model = cls(float(base), float(slope), scaled, source="fitted")
            resid = float(np.mean((model(kb, c_pe) - pj) ** 2))
            return model, resid

        if pe_scaled is not None:
            return _fit_one(bool(pe_scaled))[0]
        cands = [_fit_one(False), _fit_one(True)]
        return min(cands, key=lambda mr: mr[1])[0]


@dataclasses.dataclass(frozen=True)
class BandwidthModel:
    """Words/cycle: `coeff * C_PE` (register files), `coeff *
    sqrt(C_PE)` (banked SRAM), or a constant (external DRAM/HBM)."""

    kind: str      # "pe_linear" | "pe_sqrt" | "const"
    coeff: float

    def __post_init__(self):
        if self.kind not in ("pe_linear", "pe_sqrt", "const"):
            raise ValueError(f"unknown bandwidth kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class MemLevel:
    """One memory level.  `size_words` fixes the capacity (a constraint,
    e.g. TPU VMEM); `searched=True` makes it a search output inferred
    from the mappings (Eq. 1); neither means unconstrained (registers,
    backing DRAM)."""

    name: str
    tensors: tuple[str, ...]          # subset of ("W", "I", "O")
    word_bytes: float
    epa: EpaModel
    bandwidth: BandwidthModel
    size_words: float | None = None
    searched: bool = False
    rand_log2_kb: tuple[int, int] | None = None   # random-start range

    def __post_init__(self):
        if self.searched and self.size_words is not None:
            raise ValueError(f"{self.name}: searched levels cannot also "
                             "have a fixed size")
        for t in self.tensors:
            if t not in TENSORS:
                raise ValueError(f"{self.name}: unknown tensor {t!r}")


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """A concrete hardware point for any spec: PE-array side length plus
    one capacity (KB) per *searched* level, in spec level order.  The
    generic counterpart of `arch.GemminiHW`."""

    pe_dim: int
    cap_kb: tuple[float, ...] = ()

    @property
    def c_pe(self) -> int:
        return self.pe_dim * self.pe_dim


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Declarative accelerator description.  Levels are ordered
    innermost -> outermost; the last level is the backing store (DRAM /
    HBM) and must bind all three tensors."""

    name: str
    levels: tuple[MemLevel, ...]
    # Free spatial-tiling sites of the dataflow: (level, dim) pairs.
    spatial_sites: tuple[tuple[int, int], ...]
    # Dims allowed a temporal factor at level 0 (Gemmini WS keeps one
    # weight per PE, so only weight-irrelevant dims tile there).
    level0_temporal_dims: tuple[int, ...]
    epa_mac: float
    max_pe_dim: int
    fixed_pe_dim: int | None = None     # silicon with a fixed array
    dram_block_words: int = DRAM_BLOCK_WORDS
    sram_round_bytes: int = SRAM_ROUND_BYTES
    rand_pe_log2: tuple[int, int] = (2, 8)
    # Greedy CoSA allocation schedule: (level, dim) temporal sites,
    # innermost -> outermost.  None derives a generic schedule.
    cosa_schedule: tuple[tuple[int, int], ...] | None = None
    default_hw: HWConfig | None = None

    @property
    def n_levels(self) -> int:
        return len(self.levels)


# ---------------------------------------------------------------------------
# Ordering-combo tables (Sec. 5.2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ordering_combos_for(n_levels: int) -> np.ndarray:
    """(3**(n_levels-1), n_levels) all per-level ordering choices.
    Level 0's ordering never affects traffic (no level below it fills
    from it), so it is pinned to 0.  The array is cached and returned
    READ-ONLY: callers share one instance, so a writable array would
    let any caller's mutation poison every later caller."""
    combos = np.array([(0,) + rest for rest in
                       itertools.product(range(3), repeat=n_levels - 1)],
                      dtype=np.int64)
    combos.flags.writeable = False
    return combos


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def _readonly(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


class CompiledSpec:
    """Static tables derived from an `ArchSpec` — everything the tensor
    model, the iterative oracle, rounding, CoSA and the search engines
    consume.  Hashed by identity (one instance per spec via
    `compile_spec`'s cache) so engines keyed on it stay cached."""

    def __init__(self, spec: ArchSpec):
        nl = spec.n_levels
        if nl < 2:
            raise ValueError("need at least two memory levels")
        self.spec = spec
        self.n_levels = nl
        self.backing = nl - 1
        self.level_names = tuple(lvl.name for lvl in spec.levels)

        # --- tensor-binding matrix B (Table 4) and per-tensor chains.
        b = np.zeros((nl, NTENSORS), dtype=bool)
        for i, lvl in enumerate(spec.levels):
            for t in lvl.tensors:
                b[i, TENSORS.index(t)] = True
        if not b[self.backing].all():
            raise ValueError(f"{spec.name}: backing level "
                             f"{spec.levels[-1].name} must bind W, I, O")
        self.b_matrix = _readonly(b)
        self.tensor_levels = {
            t: tuple(int(i) for i in np.nonzero(b[:, t])[0])
            for t in range(NTENSORS)}
        if len(self.tensor_levels[2]) != 2:
            raise ValueError(f"{spec.name}: outputs must bind exactly one "
                             "accumulation level plus the backing store")

        # --- per-level constants.
        self.word_bytes = _readonly(
            np.array([lvl.word_bytes for lvl in spec.levels]))
        self.searched_levels = tuple(
            i for i, lvl in enumerate(spec.levels) if lvl.searched)
        # (level, capacity_words) pairs whose capacity is a hard
        # constraint even in mapping-first mode (fixed silicon).
        self.fixed_capacity = tuple((i, float(lvl.size_words))
                                    for i, lvl in enumerate(spec.levels)
                                    if lvl.size_words is not None)

        # --- dataflow structure.
        for (lvl, d) in spec.spatial_sites:
            if not (0 <= lvl < nl - 1) or not (0 <= d < 7):
                raise ValueError(f"bad spatial site ({lvl}, {d})")
        self.spatial_sites = tuple(spec.spatial_sites)

        # --- free-parameter mask for GD (Sec. 5.3.3): temporal factors
        # at every level but the backing store (whose factor is
        # inferred), restricted at level 0 to the dataflow-realizable
        # dims, plus the free spatial sites.
        free = np.zeros((2, nl, 7), dtype=bool)
        free[TEMPORAL, 1:self.backing, :] = True
        free[TEMPORAL, 0, list(spec.level0_temporal_dims)] = True
        for (lvl, d) in self.spatial_sites:
            free[SPATIAL, lvl, d] = True
        self.free_mask = _readonly(free)

        # --- loop-ordering combos (Sec. 5.2).
        self.combos = ordering_combos_for(nl)

        # --- greedy CoSA temporal allocation schedule.
        if spec.cosa_schedule is not None:
            self.cosa_sites = tuple(spec.cosa_schedule)
        else:
            sites: list[tuple[int, int]] = []
            for d in (Q, P, N):
                if d in spec.level0_temporal_dims:
                    sites.append((0, d))
            for i in range(1, self.backing):
                sites += [(i, d) for d in (Q, P, N, C, R, S, K)]
            self.cosa_sites = tuple(sites)

        # Tensor mirrors of the static tables, one set per device.
        self._device_tables: dict = {}

    def device_tables(self, device) -> dict:
        """The static tables the tensor model reads, as tensors on
        `device`, built once per device: ``free_mask`` (2, n_levels, 7)
        bool, ``free_idx`` (n_free,) int64 (the free sites' flat
        indices into a (2, n_levels, 7) tensor, in `free_mask`'s C
        order), ``combos`` (n_combos, n_levels) int64, ``order_table``
        (3, 7) int64 (`mapping.ORDER_TABLE`) and ``rel`` (3, 7) float32
        (`problem.REL`).  The first use builds them, before any chunk,
        so no host-to-device copy happens inside one."""
        import torch

        from ..device import canonical_device
        from .mapping import ORDER_TABLE
        from .problem import REL
        dev = canonical_device(device)
        key = str(dev)
        if key not in self._device_tables:
            self._device_tables[key] = {
                "free_mask": torch.as_tensor(self.free_mask.copy(),
                                             device=dev),
                "free_idx": torch.as_tensor(
                    np.flatnonzero(self.free_mask), device=dev),
                "combos": torch.as_tensor(self.combos.copy(), device=dev),
                "order_table": torch.as_tensor(ORDER_TABLE.copy(),
                                               device=dev),
                "rel": torch.as_tensor(REL.astype(np.float32), device=dev),
            }
        return self._device_tables[key]

    def free_mask_t(self, device):
        """`free_mask` as a bool tensor on `device`."""
        return self.device_tables(device)["free_mask"]

    @property
    def pe_cap(self) -> int:
        """The spec's PE-array side bound: the silicon side for fixed
        arrays, else the search cap.  The single source of the default
        spatial cap for rounding, random mappings and random hardware."""
        return int(self.spec.fixed_pe_dim or self.spec.max_pe_dim)

    def divisor_tables(self, dims) -> tuple[np.ndarray, np.ndarray]:
        """Padded per-(layer, dim) divisor tables for device-resident
        rounding against this spec's site schedule: (divs (L, 7, D)
        int32, logs (L, 7, D) float32).  See `padded_divisor_tables`;
        the tables depend only on the problem dims and are shared
        across specs via the module-level cache."""
        return padded_divisor_tables(dims)

    # -- hardware-point conversions ------------------------------------

    def hw_kbs(self, hw) -> tuple[float, ...]:
        """Per-searched-level capacities (KB) of a concrete hardware
        point (`HWConfig`, or the legacy `arch.GemminiHW`)."""
        kbs = (tuple(hw.cap_kb) if hasattr(hw, "cap_kb")
               else (hw.acc_kb, hw.sp_kb))
        if len(kbs) != len(self.searched_levels):
            raise ValueError(
                f"{self.spec.name}: hardware point carries {len(kbs)} "
                f"capacities, spec searches {len(self.searched_levels)}")
        return kbs

    def hw_words(self, hw) -> tuple[float, np.ndarray]:
        """(c_pe, cap_words (n_levels,)) of a concrete hardware point.
        Fixed-capacity levels take their spec size; unconstrained levels
        get +inf (their EPA slope is 0, so the value is never read)."""
        kbs = self.hw_kbs(hw)
        cap = np.full(self.n_levels, np.inf)
        for kb, i in zip(kbs, self.searched_levels):
            cap[i] = kb * 1024.0 / self.word_bytes[i]
        for (i, words) in self.fixed_capacity:
            cap[i] = words
        pe_dim = self.spec.fixed_pe_dim or hw.pe_dim
        return float(pe_dim * pe_dim), cap

    def round_caps(self, req_words) -> tuple[float, ...]:
        """Searched-level capacity requirements (words) -> KB, rounded
        up to `sram_round_bytes` increments (Sec. 6.1)."""
        import math
        out = []
        rnd = self.spec.sram_round_bytes
        for words, i in zip(req_words, self.searched_levels):
            byts = math.ceil(float(words) * self.word_bytes[i] / rnd) * rnd
            out.append(max(byts / 1024.0, 1.0))
        return tuple(out)

    # -- EPA / bandwidth evaluators (polymorphic: python floats, numpy,
    #    or torch tensors) ---------------------------------------------

    def epa(self, c_pe, cap_words) -> list:
        """Per-level energy/access given hardware parameters.
        `cap_words` is indexable by level (array or list)."""
        out = []
        for i, lvl in enumerate(self.spec.levels):
            e = lvl.epa
            if e.slope == 0.0:
                out.append(e.base)
                continue
            kb = cap_words[i] * lvl.word_bytes / 1024.0
            if e.pe_scaled:
                out.append(e.base + e.slope * kb / c_pe ** 0.5)
            else:
                out.append(e.base + e.slope * kb)
        return out

    def bandwidth(self, c_pe) -> list:
        """Per-level bandwidth in words/cycle."""
        out = []
        for lvl in self.spec.levels:
            bw = lvl.bandwidth
            if bw.kind == "pe_linear":
                out.append(bw.coeff * c_pe)
            elif bw.kind == "pe_sqrt":
                out.append(bw.coeff * c_pe ** 0.5)
            else:
                out.append(bw.coeff)
        return out


# ---------------------------------------------------------------------------
# Padded divisor tables (device-resident rounding, Sec. 5.3.2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _padded_divisor_tables(dims_key: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(divs, logs) for a workload's (L, 7) problem dims, padded to the
    widest divisor count D with zeros:

    * ``divs`` (L, 7, D) int32 — sorted divisors of ``dims[l, d]``
      (ascending, zero-padded); every integer factor a valid mapping can
      hold at any site is a divisor of its dim, so these tables are the
      complete search alphabet of the rounding projection;
    * ``logs`` (L, 7, D) float32 — ``log(divs)`` computed in float64 and
      rounded once to float32, exactly the value
      ``theta_from_mappings`` produces for that factor, so a device
      engine can rebuild post-rounding log-factors by table gather
      instead of a float32 ``log`` (bit-identical carry either way).

    Cached by the dims tuple: every engine for the same workload (and
    every spec — divisors depend only on the problem) shares one table.
    """
    from .problem import divisors
    dims = np.asarray(dims_key, dtype=np.int64)
    div_lists = [[divisors(int(n)) for n in row] for row in dims]
    width = max(len(ds) for row in div_lists for ds in row)
    divs = np.zeros(dims.shape + (width,), dtype=np.int32)
    for li, row in enumerate(div_lists):
        for di, ds in enumerate(row):
            divs[li, di, :len(ds)] = ds
    logs = np.log(np.maximum(divs, 1).astype(np.float64)).astype(np.float32)
    return _readonly(divs), _readonly(logs)


def padded_divisor_tables(dims) -> tuple[np.ndarray, np.ndarray]:
    """Public cached entry point: dims (L, 7) ints -> (divs, logs)."""
    dims = np.asarray(dims, dtype=np.int64)
    return _padded_divisor_tables(tuple(tuple(int(x) for x in row)
                                        for row in dims))


@functools.lru_cache(maxsize=None)
def sites_per_dim(cspec: CompiledSpec) -> tuple:
    """Per problem dim, the (spatial|temporal, level) sites that may hold
    an integer factor of that dim, innermost -> outermost.  The shared
    site schedule of rounding (`rounding.round_mapping`) and random
    mapping generation (`mapping.random_mapping`): level-0 temporal
    tiling is only realizable for the spec's level-0 dims
    (weight-irrelevant P/Q/N on Gemmini WS); a dim's spatial site
    precedes its temporal factor at the same level.  The backing store
    is excluded — its temporal factor absorbs the remainder."""
    spatial = {(lvl, d) for (lvl, d) in cspec.spatial_sites}
    per_dim = []
    for d in range(7):
        sites: list[tuple[int, int]] = []
        for lvl in range(cspec.backing):
            if (lvl, d) in spatial:
                sites.append((SPATIAL, lvl))
            if lvl > 0 or d in cspec.spec.level0_temporal_dims:
                sites.append((TEMPORAL, lvl))
        per_dim.append(tuple(sites))
    return tuple(per_dim)


def engine_group_key(spec) -> tuple:
    """Structural engine-sharing key for fleet co-search.  Two specs with
    the same key share the model's *structure* — same mapping tensor
    shape (2, n_levels, 7), tensor -> level chains, spatial sites, GD
    free mask and ordering-combo tables — so one fleet engine can batch
    their populations, with the numeric constants (EPA models,
    bandwidth coefficients, word sizes, PE caps, fixed/searched
    capacities) carried as per-member parameters.  Specs with
    different keys (e.g. a 4-level Gemmini vs. 3-level TPU/edge
    hierarchies) run as separate engines."""
    cspec = resolve_spec(spec)
    s = cspec.spec
    return (cspec.n_levels,
            tuple(tuple(sorted(lvl.tensors)) for lvl in s.levels),
            tuple(cspec.spatial_sites),
            tuple(sorted(s.level0_temporal_dims)))


# ---------------------------------------------------------------------------
# Workload bucketing (co-search serving).  Every distinct (L, 7) problem
# builds its own engine (tables on the device), so a server answering
# a stream of heterogeneous queries would build engines without bound.
# Padding each problem dim UP to a small canonical grid maps the stream
# onto a bounded set of canonical workloads: engine builds are bounded
# and the cache hit rate stays high, at the cost of searching a
# slightly-enlarged problem (the padded EDP upper-bounds the original's
# — padding a dim only adds MACs/words, exactly like the zero-padding a
# real kernel launch would do).
# ---------------------------------------------------------------------------

def bucket_dim(n: int) -> int:
    """The canonical padded size of one problem dim: dims <= 8 are kept
    exact (R/S/Q are tiny and structurally meaningful), larger dims
    round up to the {2**k, 3 * 2**(k-1)} ladder (12, 16, 24, 32, 48,
    64, ...).  Ladder values are divisor-rich — the rounding projection
    and spatial tiling need factorable dims — and consecutive steps are
    <= 4/3 apart, so padding inflates a dim by < 34%."""
    n = int(n)
    if n <= 8:
        return n
    cand = 8
    while cand < n:
        # the ladder alternates 2**k -> 3*2**(k-1) -> 2**(k+1) -> ...
        cand = cand + cand // 2 if _is_pow2(cand) else cand * 4 // 3
    return cand


def _is_pow2(n: int) -> bool:
    return n & (n - 1) == 0


def bucket_workload(workload):
    """Pad every layer dim of `workload` up to the canonical grid
    (`bucket_dim`) and return the canonical `Workload`.  Strides and
    repeats are preserved (they scale the objective and must not
    change); the name is derived from the canonical content, so two
    differently-named source workloads that pad to the same shape
    compare equal — and therefore share one compiled engine."""
    from .problem import Layer, Workload
    layers = []
    sig = []
    for i, lay in enumerate(workload.layers):
        dims = tuple(bucket_dim(d) for d in lay.dims)
        # Layer names participate in Workload equality (and therefore in
        # engine-cache keys), so they are canonicalized too.
        layers.append(Layer(dims=dims, wstride=lay.wstride,
                            hstride=lay.hstride, repeat=lay.repeat,
                            name=f"l{i}"))
        sig.append("x".join(str(d) for d in dims)
                   + f"s{lay.wstride}.{lay.hstride}r{lay.repeat}")
    return Workload(layers=tuple(layers), name="bkt_" + "_".join(sig))


def engine_bucket_key(spec, workload) -> tuple:
    """The serving-layer bucket key of a (spec, workload) query: the
    spec's structural engine group (`engine_group_key`) plus the
    canonical padded problem signature.  Two requests with equal keys
    are served by the same warm engine family — same model structure
    AND same workload constants after bucketing."""
    canon = bucket_workload(workload)
    return (engine_group_key(spec),
            tuple((lay.dims, lay.wstride, lay.hstride, lay.repeat)
                  for lay in canon.layers))


@functools.lru_cache(maxsize=None)
def compile_spec(spec: ArchSpec) -> CompiledSpec:
    """Lower an `ArchSpec` to its static model tables.  Cached: the same
    spec always returns the same `CompiledSpec` instance, so closures
    and engine caches keyed on it are shared.  Every cache miss runs the
    full spec lint (`analysis.speclint`) first, so a malformed
    spec fails with rule IDs before any table is built."""
    from ..analysis.speclint import check_spec  # lazy: avoids cycle
    check_spec(spec)
    return CompiledSpec(spec)


def resolve_spec(spec) -> CompiledSpec:
    """Accept None (-> Gemmini), an ArchSpec, or an already-compiled
    spec; return the CompiledSpec."""
    if spec is None:
        return compile_spec(GEMMINI_SPEC)
    if isinstance(spec, CompiledSpec):
        return spec
    return compile_spec(spec)


# ---------------------------------------------------------------------------
# Gemmini (paper Table 2 / Table 4) — the legacy constants as data.
# ---------------------------------------------------------------------------

GEMMINI_SPEC = ArchSpec(
    name="gemmini",
    levels=(
        MemLevel("Registers", ("W",), word_bytes=1.0,
                 epa=EpaModel(EPA_REG),
                 bandwidth=BandwidthModel("pe_linear", 2.0)),
        MemLevel("Accumulator", ("O",), word_bytes=4.0,
                 epa=EpaModel(EPA_ACC_BASE, EPA_ACC_SLOPE, pe_scaled=True),
                 bandwidth=BandwidthModel("pe_sqrt", 2.0),
                 searched=True, rand_log2_kb=(3, 10)),
        MemLevel("Scratchpad", ("W", "I"), word_bytes=1.0,
                 epa=EpaModel(EPA_SP_BASE, EPA_SP_SLOPE),
                 bandwidth=BandwidthModel("pe_sqrt", 2.0),
                 searched=True, rand_log2_kb=(5, 12)),
        MemLevel("DRAM", ("W", "I", "O"), word_bytes=1.0,
                 epa=EpaModel(EPA_DRAM),
                 bandwidth=BandwidthModel("const", DRAM_BW)),
    ),
    spatial_sites=((1, C), (2, K)),      # WS dataflow: C|K (Eq. 1)
    level0_temporal_dims=(P, Q, N),
    epa_mac=EPA_MAC,
    max_pe_dim=MAX_PE_DIM,
    # The exact greedy schedule of the legacy CoSA stand-in.
    cosa_schedule=((0, Q), (0, P), (0, N),
                   (1, Q), (1, P), (1, N),
                   (2, C), (2, R), (2, S), (2, K), (2, Q), (2, P)),
)


# ---------------------------------------------------------------------------
# TPU v5e (DESIGN.md Sec. 5) — fixed silicon, mapping-only search.
#
# The cycles-domain model needs a clock to express HBM bandwidth in
# words/cycle: one "virtual MXU" of 128x128 MACs running at
# peak_flops / (2 * 128^2) reproduces the chip's peak exactly, and
# hbm_bw / (word_bytes * clock) its memory roofline.  EPA constants are
# representative pJ/word figures (register file / large SRAM / HBM) —
# the paper gives none for TPU; EDP *ratios* across mappings are what
# the search consumes.
# ---------------------------------------------------------------------------

_TPU_CLOCK_HZ = TPU_V5E.peak_flops / (2.0 * TPU_V5E.mxu_dim ** 2)
_TPU_WORD_BYTES = 2.0                                  # bf16 datapath
_TPU_HBM_WPC = TPU_V5E.hbm_bw / (_TPU_WORD_BYTES * _TPU_CLOCK_HZ)

TPU_V5E_SPEC = ArchSpec(
    name="tpu_v5e",
    levels=(
        MemLevel("VREG", ("W",), word_bytes=_TPU_WORD_BYTES,
                 epa=EpaModel(0.2),
                 bandwidth=BandwidthModel("pe_linear", 2.0)),
        MemLevel("VMEM", ("W", "I", "O"), word_bytes=_TPU_WORD_BYTES,
                 epa=EpaModel(1.5),
                 bandwidth=BandwidthModel("pe_sqrt", 2.0),
                 size_words=TPU_V5E.vmem_bytes / _TPU_WORD_BYTES),
        MemLevel("HBM", ("W", "I", "O"), word_bytes=_TPU_WORD_BYTES,
                 epa=EpaModel(60.0),
                 bandwidth=BandwidthModel("const", _TPU_HBM_WPC)),
    ),
    spatial_sites=((1, C), (1, K)),
    level0_temporal_dims=(P, Q, N),
    epa_mac=0.3,
    max_pe_dim=TPU_V5E.mxu_dim,
    fixed_pe_dim=TPU_V5E.mxu_dim,        # the array is silicon
    dram_block_words=16,
    default_hw=HWConfig(pe_dim=TPU_V5E.mxu_dim, cap_kb=()),
)


# ---------------------------------------------------------------------------
# A 3-level edge accelerator: per-PE weight registers, one shared
# (searched) SRAM holding weights+inputs+outputs, narrow LPDDR.  Exists
# to prove the compiled-spec path generalizes across hierarchy depths:
# 9 ordering combos, a 3-tensor shared buffer, a 32x32 PE cap.
# ---------------------------------------------------------------------------

EDGE_SPEC = ArchSpec(
    name="edge3",
    levels=(
        MemLevel("Registers", ("W",), word_bytes=1.0,
                 epa=EpaModel(EPA_REG),
                 bandwidth=BandwidthModel("pe_linear", 2.0)),
        MemLevel("SharedSRAM", ("W", "I", "O"), word_bytes=1.0,
                 epa=EpaModel(0.6, 0.018),
                 bandwidth=BandwidthModel("pe_sqrt", 2.0),
                 searched=True, rand_log2_kb=(6, 12)),
        MemLevel("LPDDR", ("W", "I", "O"), word_bytes=1.0,
                 epa=EpaModel(EPA_DRAM),
                 bandwidth=BandwidthModel("const", 4.0)),
    ),
    spatial_sites=((1, C), (1, K)),
    level0_temporal_dims=(P, Q, N),
    epa_mac=EPA_MAC,
    max_pe_dim=32,
    rand_pe_log2=(2, 6),                 # 4..32
)
