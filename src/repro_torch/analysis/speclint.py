"""Static lint for `ArchSpec` declarations (rule family ``SP5xx``).

`compile_spec` already rejects a handful of malformed specs while
building its tables; this module is the complete, declarative version:
every structural invariant the tensor model, rounding projection and
search engines assume about a spec, checked up front with a rule ID
and an actionable message — so a new spec (the ROADMAP's HBM/FPGA
targets) fails loudly at declaration time, not as a shape error three
layers into a search.

``lint_spec(spec)`` returns all violations; ``check_spec`` raises
`SpecLintError` (a ``ValueError``) listing them.  `compile_spec` calls
``check_spec`` on every cache miss.  The PyTorch port's own copy of
the reference's `repro.analysis.speclint`.
"""
from __future__ import annotations

import dataclasses

from ..core.problem import TENSORS

_NDIMS = 7
_O = TENSORS.index("O")


@dataclasses.dataclass(frozen=True)
class SpecIssue:
    rule: str
    where: str       # spec-relative locus, e.g. "levels[1].epa"
    message: str

    def __str__(self) -> str:
        return f"{self.rule} at {self.where}: {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class SpecLintError(ValueError):
    """An ArchSpec violates a structural invariant."""

    def __init__(self, spec_name: str, issues: list[SpecIssue]):
        self.issues = issues
        lines = "\n".join(f"  - {i}" for i in issues)
        super().__init__(
            f"ArchSpec {spec_name!r} failed spec lint "
            f"({len(issues)} issue(s)):\n{lines}")


def lint_spec(spec) -> list[SpecIssue]:
    """All SP5xx violations of an `ArchSpec` (empty list = clean).
    Purely structural — never compiles or traces anything."""
    out: list[SpecIssue] = []

    def add(rule, where, msg):
        out.append(SpecIssue(rule, where, msg))

    levels = tuple(spec.levels)
    nl = len(levels)

    # SP501 — hierarchy depth
    if nl < 2:
        add("SP501", "levels",
            f"{nl} memory level(s); the model needs an innermost level "
            "plus a backing store (>= 2)")
        return out  # everything below indexes levels[-1]
    backing = nl - 1

    # SP502 — binding matrix: backing binds every tensor
    missing = [t for t in TENSORS if t not in levels[backing].tensors]
    if missing:
        add("SP502", f"levels[{backing}].tensors",
            f"backing store {levels[backing].name!r} must bind all of "
            f"{TENSORS}; missing {tuple(missing)} — every tensor's level "
            "chain terminates at the backing store")

    # SP503 — tensor chain reachability: each tensor staged on-chip
    for ti, t in enumerate(TENSORS):
        chain = [i for i, lvl in enumerate(levels) if t in lvl.tensors]
        if not any(i < backing for i in chain):
            add("SP503", f"tensors[{t}]",
                f"tensor {t!r} binds no level below the backing store — "
                "its chain is unreachable (never staged on-chip); bind "
                "it at an inner level")
        if ti == _O and len(chain) != 2:
            # SP504 — outputs: exactly one accumulation level + backing
            add("SP504", "tensors[O]",
                f"outputs bind {len(chain)} level(s) {tuple(chain)}; the "
                "reduction model requires exactly one accumulation level "
                "plus the backing store")

    # SP505 / SP506 / SP509 — per-level models
    for i, lvl in enumerate(levels):
        e = lvl.epa
        if e.base < 0.0 or e.slope < 0.0:
            add("SP505", f"levels[{i}].epa",
                f"{lvl.name}: EPA coefficients (base={e.base}, "
                f"slope={e.slope}) must be nonnegative — energy per "
                "access is physical")
        elif e.base == 0.0 and e.slope == 0.0:
            add("SP505", f"levels[{i}].epa",
                f"{lvl.name}: EPA is identically zero; a free memory "
                "level makes the energy objective degenerate")
        if not (lvl.bandwidth.coeff > 0.0):
            add("SP506", f"levels[{i}].bandwidth",
                f"{lvl.name}: bandwidth coeff {lvl.bandwidth.coeff} must "
                "be positive or the latency model divides by zero")
        if not (lvl.word_bytes > 0.0):
            add("SP509", f"levels[{i}].word_bytes",
                f"{lvl.name}: word_bytes {lvl.word_bytes} must be "
                "positive")
        if lvl.size_words is not None and not (lvl.size_words > 0):
            add("SP509", f"levels[{i}].size_words",
                f"{lvl.name}: fixed capacity {lvl.size_words} must be "
                "positive")
    if not (spec.epa_mac > 0.0):
        add("SP505", "epa_mac",
            f"epa_mac {spec.epa_mac} must be positive — the compute "
            "energy floor anchors the EDP objective")

    # SP507 — spatial sites within the dataflow's reach
    seen_sites = set()
    for si, (lvl, d) in enumerate(spec.spatial_sites):
        if not (0 <= lvl < backing) or not (0 <= d < _NDIMS):
            add("SP507", f"spatial_sites[{si}]",
                f"site ({lvl}, {d}) out of range: level must be in "
                f"[0, {backing}) (below the backing store) and dim in "
                f"[0, {_NDIMS})")
        elif (lvl, d) in seen_sites:
            add("SP507", f"spatial_sites[{si}]",
                f"site ({lvl}, {d}) declared twice")
        seen_sites.add((lvl, d))

    # SP508 — level-0 temporal dims
    for d in spec.level0_temporal_dims:
        if not (0 <= d < _NDIMS):
            add("SP508", "level0_temporal_dims",
                f"dim {d} out of range [0, {_NDIMS})")

    # SP510 — PE array bounds
    if not (spec.max_pe_dim >= 1):
        add("SP510", "max_pe_dim",
            f"max_pe_dim {spec.max_pe_dim} must be >= 1")
    if spec.fixed_pe_dim is not None and \
            not (1 <= spec.fixed_pe_dim <= spec.max_pe_dim):
        add("SP510", "fixed_pe_dim",
            f"fixed_pe_dim {spec.fixed_pe_dim} must lie in "
            f"[1, max_pe_dim={spec.max_pe_dim}]")

    # SP511 — rounding/divisor-table invariants: the rounding
    # projection quantizes SRAM bytes and DRAM blocks by these strides.
    if not (isinstance(spec.sram_round_bytes, int)
            and spec.sram_round_bytes >= 1):
        add("SP511", "sram_round_bytes",
            f"sram_round_bytes {spec.sram_round_bytes!r} must be a "
            "positive int — capacity rounding quantizes by it")
    if not (isinstance(spec.dram_block_words, int)
            and spec.dram_block_words >= 1):
        add("SP511", "dram_block_words",
            f"dram_block_words {spec.dram_block_words!r} must be a "
            "positive int — DRAM traffic rounds up to whole blocks")

    # SP512 — random-start ranges
    if spec.rand_pe_log2[0] > spec.rand_pe_log2[1]:
        add("SP512", "rand_pe_log2",
            f"empty range {spec.rand_pe_log2}; (lo, hi) needs lo <= hi")
    for i, lvl in enumerate(levels):
        r = lvl.rand_log2_kb
        if r is not None and r[0] > r[1]:
            add("SP512", f"levels[{i}].rand_log2_kb",
                f"{lvl.name}: empty range {r}; (lo, hi) needs lo <= hi")

    # SP513 — CoSA schedule sites in range (temporal, below backing)
    if spec.cosa_schedule is not None:
        for si, (lvl, d) in enumerate(spec.cosa_schedule):
            if not (0 <= lvl < backing) or not (0 <= d < _NDIMS):
                add("SP513", f"cosa_schedule[{si}]",
                    f"site ({lvl}, {d}) out of range: temporal "
                    f"allocation runs below the backing store "
                    f"(level in [0, {backing}), dim in [0, {_NDIMS}))")

    # SP514 — default hardware point matches the searched levels
    if spec.default_hw is not None:
        n_searched = sum(1 for lvl in levels if lvl.searched)
        if len(spec.default_hw.cap_kb) != n_searched:
            add("SP514", "default_hw",
                f"default_hw carries {len(spec.default_hw.cap_kb)} "
                f"capacit(ies), spec searches {n_searched} level(s)")

    return out


def check_spec(spec) -> None:
    """Raise `SpecLintError` if ``lint_spec`` finds any violation."""
    issues = lint_spec(spec)
    if issues:
        raise SpecLintError(getattr(spec, "name", "<spec>"), issues)
