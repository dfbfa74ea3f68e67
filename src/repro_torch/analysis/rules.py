"""Lint-rule catalog of the PyTorch port: every rule the AST pass
enforces, with its ID, rationale and an actionable message, plus the
device scopes the ``TH1xx`` rules read.

Rule families:

* ``TH1xx`` — torch device hazards: code inside a fused device chunk
  that reads a value back to the host, branches in Python on a tensor's
  value, computes in float64, or differentiates through ``prod`` /
  ``cumprod`` (whose backward reads a zero count back to the host).
  Any of them stalls the host on the card, and a chunk that must be
  captured or run under ``torch.cuda.set_sync_debug_mode("error")``
  cannot contain it.
* ``ND2xx`` — nondeterminism in engine code: unseeded RNG streams and
  wall-clock reads make seeded bit-identical parity impossible.
* ``EX3xx`` — exception hygiene: a broad ``except`` that swallows is how
  preemptions, OOMs and real bugs disappear from a serving loop.
* ``PY4xx`` — Python footguns (mutable default arguments).
* ``OB6xx`` — observability hygiene: timing goes through the telemetry
  spine (`repro_torch.obs`), one injected clock.

The reference (`repro.analysis.rules`) marks traced code by `jax.jit`
decorators and scan/shard_map bodies.  Eager PyTorch has no such
marker, so the port names its device code in `DEVICE_SCOPES` instead.
Each reference rule maps to a port rule:

=====  ==========================  =====  ================================
Ref.   reference rule              Port   port rule
=====  ==========================  =====  ================================
JX101  numpy-in-traced-body        TH101  host-read-in-device-scope
JX102  python-branch-in-scan-body  TH102  data-dependent-branch-in-device-
                                          scope
JX103  f64-literal-in-traced-body  TH103  f64-in-device-scope
JX104  jit-without-donation        --     none: torch has no buffer
                                          donation (an eager op frees its
                                          input when the last reference
                                          goes: no second copy to donate)
--     --                          TH104  prod-on-gradient-path
ND201  unseeded-rng-in-engine      ND201  the same
ND202  wallclock-in-engine         ND202  the same
EX301  exception-swallowed         EX301  the same
PY401  mutable-default-argument    PY401  the same
OB601  wallclock-outside-obs       OB601  the same
=====  ==========================  =====  ================================

TH104 has no reference counterpart because the hazard does not exist
there: the gradient of ``jnp.prod`` traces to device code, while the
backward of ``torch.prod`` and ``torch.cumprod`` counts zeros on the
host.  The dynamic contract
cannot see it (under a dispatch mode autograd takes the sync-free
formula), so only the lint rule catches it.

A rule fires as a `LintViolation` (see `astlint`).  Accepted patterns
live in the checked-in baseline (``analysis_baseline.json``); new
violations fail the gate.  Inline suppression: append
``# repro-lint: allow[RULE_ID]`` (with a reason in a nearby comment)
to the flagged line — the same comment the reference's linter reads.
"""
from __future__ import annotations

import dataclasses

# Engine paths for the ND2xx rules.  `sharding/` is kept for the
# population sharding the port has not reached yet.
_ENGINE_PATHS = ("src/repro_torch/core/", "src/repro_torch/serve/",
                 "src/repro_torch/runtime/", "src/repro_torch/sharding/")


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    message: str           # actionable: what to do instead
    # Restrict the rule to paths containing one of these fragments
    # (POSIX relpaths); empty tuple = everywhere.
    path_filters: tuple[str, ...] = ()
    # Exempt paths containing one of these fragments — for rules that
    # apply everywhere EXCEPT the module that owns the pattern (e.g.
    # the telemetry clock).  Checked after path_filters.
    path_excludes: tuple[str, ...] = ()


RULES: dict[str, Rule] = {r.id: r for r in (
    Rule(
        "TH101", "host-read-in-device-scope",
        ".item()/.tolist()/.cpu()/.numpy()/nonzero/unique/masked_select, "
        "float()/int()/bool() of a tensor, .to() a named device or an "
        "np.* call inside a device scope reads the tensor back to the "
        "host and stalls the card; keep the value on the device "
        "(torch.where, gather, argmin with keepdim) and read it once "
        "after the chunk (a host config value: suppress inline with "
        "the reason)"),
    Rule(
        "TH102", "data-dependent-branch-in-device-scope",
        "Python `if`/`while` on a tensor's value inside a device scope "
        "synchronizes with the host to decide the branch; compute both "
        "sides and select with torch.where, or branch on configuration "
        "values only"),
    Rule(
        "TH103", "f64-in-device-scope",
        "float64 inside a device scope doubles the memory traffic and "
        "runs at a fraction of the float32 rate on the card; keep device "
        "tensors float32, or compute in float64 on the host and cast "
        "once at the boundary"),
    Rule(
        "TH104", "prod-on-gradient-path",
        "torch.prod/cumprod (or .prod()/.cumprod()) inside a device "
        "scope: their backward counts zeros on the host; write the "
        "product as explicit multiplications (model._seq_prod, "
        "model._prod_all)"),
    Rule(
        "ND201", "unseeded-rng-in-engine",
        "unseeded RNG (np.random.* legacy global stream / "
        "random.* / default_rng()) in engine code breaks seeded "
        "bit-identical parity; thread an explicit seeded "
        "np.random.default_rng(seed) / torch.Generator through",
        path_filters=_ENGINE_PATHS),
    Rule(
        "ND202", "wallclock-in-engine",
        "wall-clock read (time.time/perf_counter) in engine code makes "
        "results run-dependent; timing belongs in benchmarks/ or behind "
        "an injected clock",
        path_filters=_ENGINE_PATHS),
    Rule(
        "OB601", "wallclock-outside-obs",
        "direct wall-clock call (time.time/perf_counter/monotonic) "
        "outside the telemetry spine; time through "
        "repro_torch.obs.telemetry.default_clock / a tracer span (or "
        "the injected clock_fn at serving boundaries) so every duration "
        "shares one clock and shows up in /v1/metrics",
        path_excludes=("src/repro_torch/obs/", "benchmarks/")),
    Rule(
        "EX301", "exception-swallowed",
        "broad `except Exception`/bare `except` that neither re-raises "
        "nor chains hides preemptions and real bugs; catch the specific "
        "exception types the path can produce, or re-raise with "
        "context"),
    Rule(
        "PY401", "mutable-default-argument",
        "mutable default argument is shared across calls; default to "
        "None and construct inside the function"),
)}


# The port's device code: (path fragment, qualified name) pairs.  A
# function whose qualified name equals or nests inside a listed name,
# in a file whose POSIX relpath contains the fragment, is a device
# scope for the TH1xx rules.  The list starts from what the fused
# chunk and the fleet segment run and follows what those functions
# call, down to the cost model; engine *builders* (which put tables on
# the device once, before any chunk) are left out, and only the
# closures they return are listed.
DEVICE_SCOPES: tuple[tuple[str, str], ...] = (
    # core/search.py: the fused chunk, its Adam and its ordering CD.
    ("src/repro_torch/core/search.py", "FusedEngine.segment"),
    ("src/repro_torch/core/search.py", "FusedEngine.run"),
    ("src/repro_torch/core/search.py", "_adam_segment"),
    ("src/repro_torch/core/search.py", "adam_step"),
    ("src/repro_torch/core/search.py", "_cd_orderings"),
    ("src/repro_torch/core/search.py", "_seq_sum"),
    ("src/repro_torch/core/search.py", "_population_hw"),
    ("src/repro_torch/core/search.py", "_population_choice"),
    ("src/repro_torch/core/search.py", "build_f"),
    ("src/repro_torch/core/search.py", "_spatial_cap_penalty"),
    ("src/repro_torch/core/search.py", "_loss_grad.grad"),
    ("src/repro_torch/core/search.py", "_make_loss_fn.surrogate_latency"),
    ("src/repro_torch/core/search.py", "_make_loss_fn.edp_fixed_orders"),
    ("src/repro_torch/core/search.py", "_make_loss_fn.edp_softmax"),
    ("src/repro_torch/core/search.py",
     "_make_loss_fn.fixed_silicon_penalty"),
    ("src/repro_torch/core/search.py", "_make_loss_fn.loss"),
    # core/rounding.py: the device projection and device seeding.
    ("src/repro_torch/core/rounding.py", "_round_population_core"),
    ("src/repro_torch/core/rounding.py", "_seed_population_core"),
    # core/fleet.py: the fleet segment and its member-parametric loss.
    ("src/repro_torch/core/fleet.py", "FusedFleetEngine.segment"),
    ("src/repro_torch/core/fleet.py", "FusedFleetEngine.run"),
    ("src/repro_torch/core/fleet.py", "_fleet_loss_fn.loss"),
    ("src/repro_torch/core/fleet.py", "_member_grad.grad"),
    ("src/repro_torch/core/fleet.py", "member_edp"),
    ("src/repro_torch/core/fleet.py", "_per_layer"),
    ("src/repro_torch/core/fleet.py", "_epa_param"),
    ("src/repro_torch/core/fleet.py", "_bw_param"),
    ("src/repro_torch/core/fleet.py", "_infer_hw_param"),
    ("src/repro_torch/core/fleet.py", "_layer_el_param"),
    # core/model.py: the cost model the losses and the chunk call.
    ("src/repro_torch/core/model.py", "relu"),
    ("src/repro_torch/core/model.py", "_seq_prod"),
    ("src/repro_torch/core/model.py", "_prod_all"),
    ("src/repro_torch/core/model.py", "_extents"),
    ("src/repro_torch/core/model.py", "capacities"),
    ("src/repro_torch/core/model.py", "_nest_above"),
    ("src/repro_torch/core/model.py", "_fill_multiplier"),
    ("src/repro_torch/core/model.py", "spatial_discount"),
    ("src/repro_torch/core/model.py", "_fills"),
    ("src/repro_torch/core/model.py", "fills_spec"),
    ("src/repro_torch/core/model.py", "traffic_spec"),
    ("src/repro_torch/core/model.py", "utilized_pes"),
    ("src/repro_torch/core/model.py", "layer_c_pe_spec"),
    ("src/repro_torch/core/model.py", "_epa"),
    ("src/repro_torch/core/model.py", "layer_metrics_spec"),
    ("src/repro_torch/core/model.py", "infer_hw_spec"),
    ("src/repro_torch/core/model.py", "workload_eval_spec"),
    ("src/repro_torch/core/model.py", "population_edp_spec"),
    ("src/repro_torch/core/model.py", "population_best_init"),
    ("src/repro_torch/core/model.py", "population_best_update"),
    ("src/repro_torch/core/model.py", "validity_penalty"),
    ("src/repro_torch/core/model.py", "capacity_penalty_spec"),
    ("src/repro_torch/core/model.py", "layer_el_all_orderings_spec"),
    ("src/repro_torch/core/model.py",
     "layer_el_all_orderings_population_spec"),
    ("src/repro_torch/core/archspec.py", "CompiledSpec.bandwidth"),
    # The calibrated loss's learned latency (surrogate_latency above).
    ("src/repro_torch/core/calibration.py", "traced_features"),
    ("src/repro_torch/core/surrogate.py", "mlp_apply"),
)


def device_scopes_for(relpath: str) -> frozenset[str]:
    """Qualified names of the device scopes in the file at `relpath`."""
    return frozenset(q for frag, q in DEVICE_SCOPES if frag in relpath)
