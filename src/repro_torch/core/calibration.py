"""Spec-generic calibration subsystem (paper Sec. 6.5), on torch.

The PyTorch port of `repro.core.calibration`.  Everything but
`traced_features` (the in-loss feature path, on tensors) and model
training (`core.surrogate`, on the named device) is host numpy, held to
the reference number for number by `tests/test_torch_calibration.py`.
Datasets and `Calibration` bundles use the reference's artifact format,
so each package loads what the other saved.

The paper's flexibility headline is closing the model-to-hardware gap:
augment the analytical model with a learned latency model, fit energy
numbers from measurement, and *descend through the result* in the same
one-loop search.  This module makes every `ArchSpec` calibratable:

* **featurization** — `featurize_spec` derives each spec's feature
  vector from its compiled tables (log problem dims, log tiling factors
  at the spec's GD free-mask sites, loop-ordering one-hots for every
  level above the registers, log searched-capacity/PE hardware
  parameters).  For Gemmini this reproduces the legacy hard-coded
  `surrogate.featurize` bit for bit (golden-tested);
* **fitted EPA** — `calibrate_epa(spec, samples)` least-squares fits
  every SRAM level's `EpaModel` coefficients to CACTI/Accelergy-style
  measurement tables (`measured_epa_samples` ships a deterministic
  stand-in), returning a new `ArchSpec` whose energy comes from
  measurement instead of Table-2 constants;
* **learned residual latency** — `build_calibration_dataset` samples
  random valid mappings per spec, labels them with the spec-generic
  RTL stand-in (`rtl_sim.rtl_latency(..., spec=s)`), and the trained
  residual MLP (`surrogate.train_residual_model`) composes with the
  analytical model *inside* the search loss (`traced_features` is the
  differentiable feature path `search._make_loss_fn` consumes), so
  `dosa_search` descends through it on any spec;
* **persistence** — datasets and `Calibration` bundles (fitted EPA
  coefficients as JSON + trained model as npz) save/load, so expensive
  measurement and training are one-time artifacts.

`calibrate(spec, workload)` runs the whole pipeline: sample -> label ->
fit EPA -> train residual model -> report metrics (Spearman, val MSE).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE
from .archspec import (ArchSpec, CompiledSpec, EpaModel, HWConfig,
                       resolve_spec)
from .hw_infer import minimal_hw_for
from .mapping import Mapping, random_mapping
from .oracle import evaluate
from .problem import Layer
from .rtl_sim import rtl_latency
from .surrogate import TrainedModel, spearman, train_residual_model


# ---------------------------------------------------------------------------
# Spec-generic featurization
# ---------------------------------------------------------------------------

def n_features(spec=None) -> int:
    """Feature-vector width of a spec's calibration featurization:
    7 log dims + one log factor per GD free-mask site + a 3-way
    ordering one-hot per level above the registers + log PE side + one
    log capacity per searched level.  Gemmini: 7 + 19 + 9 + 3 = 38,
    matching the legacy `surrogate.N_FEATURES`."""
    cspec = resolve_spec(spec)
    return (7 + int(cspec.free_mask.sum()) + 3 * (cspec.n_levels - 1)
            + 1 + len(cspec.searched_levels))


def featurize_spec(m: Mapping, layer: Layer, hw, spec=None) -> np.ndarray:
    """Feature vector of one (mapping, layer, hardware) sample for any
    `ArchSpec` target.  `hw` is an `HWConfig` (or legacy `GemminiHW`)
    carrying the PE side and the searched-level capacities.  For the
    Gemmini spec this is bit-identical to the legacy hard-coded
    `surrogate.featurize` (same sites, same order, same dtypes)."""
    cspec = resolve_spec(spec)
    if m.f.shape != (2, cspec.n_levels, 7):
        raise ValueError(
            f"mapping factor tensor {m.f.shape} does not fit "
            f"{cspec.spec.name}'s (2, {cspec.n_levels}, 7) hierarchy")
    dims = np.log(np.asarray(layer.dims, dtype=float))
    factors = np.log(np.maximum(m.f[cspec.free_mask], 1.0))
    orders = np.zeros((cspec.n_levels - 1, 3))
    for i, lvl in enumerate(range(1, cspec.n_levels)):
        orders[i, int(m.order[lvl])] = 1.0
    kbs = cspec.hw_kbs(hw)
    # Fixed-silicon specs pin the array side regardless of the hardware
    # point (mirrors `hw_words`, which computes the labels' c_pe), so
    # features and labels always describe the same hardware.
    pe_dim = cspec.spec.fixed_pe_dim or hw.pe_dim
    hwf = np.log(np.array([pe_dim, *kbs], dtype=float))
    return np.concatenate([dims, factors, orders.ravel(), hwf])


def traced_features(cspec: CompiledSpec, theta: torch.Tensor,
                    orders: torch.Tensor, logdims: torch.Tensor,
                    hw) -> torch.Tensor:
    """The differentiable twin of `featurize_spec`, assembled inside the
    search loss: (..., L, n_features) features from the GD state.
    `theta` (..., L, 2, n_levels, 7) log-factors (the free-site entries
    ARE the log-factor features), `orders` (..., L, n_levels) int,
    `logdims` (L, 7), `hw` a `model.SpecHW` with (...,) / (...,
    n_levels) leaves.  The free sites are gathered through the spec's
    device index table, so nothing here copies from the host."""
    L = theta.shape[-4]
    nl = cspec.n_levels
    batch = theta.shape[:-4]
    free_idx = cspec.device_tables(theta.device)["free_idx"]
    fac = torch.index_select(theta.flatten(-3), -1, free_idx)  # (.., n_free)
    oh = F.one_hot(orders[..., 1:nl], 3).to(theta.dtype).reshape(
        batch + (L, 3 * (nl - 1)))
    hw_feats = [torch.log(torch.sqrt(hw.c_pe))]
    for i in cspec.searched_levels:
        # the spec's host table, not a tensor
        wb = float(cspec.word_bytes[i])  # repro-lint: allow[TH101]
        kb = hw.cap_words[..., i] * wb / 1024.0
        hw_feats.append(torch.log(kb))
    hwf = torch.stack(hw_feats, dim=-1)                  # (..., n_hw)
    hwf = hwf[..., None, :].expand(batch + (L, len(hw_feats)))
    return torch.cat([logdims.expand(batch + logdims.shape), fac, oh, hwf],
                     dim=-1)


def check_surrogate(model: TrainedModel, spec=None) -> None:
    """Fail loudly when a trained model does not belong to the target
    spec: a mismatched feature width would die deep in the loss, and
    a same-width model trained against a *different* target's labels
    would silently steer the search with the wrong physics (the
    cross-target hazard the old Gemmini-only guard prevented)."""
    cspec = resolve_spec(spec)
    expect = n_features(cspec)
    if model.n_features != expect:
        raise ValueError(
            f"surrogate was trained on {model.n_features} features "
            f"(spec {model.spec_name!r}); target {cspec.spec.name!r} "
            f"featurizes to {expect}.  Calibrate a model per spec "
            "(core.calibration.calibrate).")
    if model.spec_name != cspec.spec.name:
        raise ValueError(
            f"surrogate was calibrated for spec {model.spec_name!r}, "
            f"not {cspec.spec.name!r}.  Calibrate a model per spec "
            "(core.calibration.calibrate), or set "
            "TrainedModel.spec_name when training by hand.")


# ---------------------------------------------------------------------------
# Fitted EPA (CACTI/Accelergy-style measurement tables)
# ---------------------------------------------------------------------------

# Deterministic distortion of the Table-2 constants standing in for a
# real CACTI/Accelergy sweep: measured SRAM energy differs from the
# paper constants by a level-dependent gain, a sqrt-capacity wire term,
# and ~3% sample jitter.  Fixed constants => reproducible experiments.
_MEASURED_BASE_GAIN = 1.22
_MEASURED_SLOPE_GAIN = 0.81
_MEASURED_SQRT_PJ = 0.035
_MEASURED_JITTER = 0.03


def _sample_jitter(name: str, kb: float) -> float:
    h = hashlib.sha256(f"{name}:{kb:.6e}".encode()).digest()
    u = int.from_bytes(h[:8], "little") / 2 ** 64
    return 1.0 + _MEASURED_JITTER * (2.0 * u - 1.0)


def measured_epa_samples(spec: ArchSpec, level: int,
                         kb_grid=None, c_pe: float = 256.0):
    """A CACTI/Accelergy-style energy-per-access table for one memory
    level: (kb, c_pe, pj) sample arrays over a log-spaced capacity grid.
    Deterministic stand-in for real measurement (like `rtl_sim` is for
    FireSim): the spec's analytical EPA distorted by fixed gains, a
    sqrt-capacity wire-energy term, and seeded per-sample jitter."""
    lvl = spec.levels[level]
    if kb_grid is None:
        lo, hi = lvl.rand_log2_kb if lvl.rand_log2_kb is not None \
            else (2, 11)
        kb_grid = np.logspace(np.log10(2.0 ** lo), np.log10(2.0 ** hi), 24)
    kb = np.asarray(kb_grid, dtype=float)
    base = lvl.epa(kb, c_pe)
    pj = (_MEASURED_BASE_GAIN * lvl.epa.base
          + _MEASURED_SLOPE_GAIN * (base - lvl.epa.base)
          + _MEASURED_SQRT_PJ * np.sqrt(kb))
    pj = pj * np.array([_sample_jitter(f"{spec.name}/{lvl.name}", k)
                        for k in kb])
    return kb, np.full_like(kb, float(c_pe)), pj


def calibrate_epa(spec: ArchSpec, samples=None) -> ArchSpec:
    """Fit every capacity-dependent memory level's `EpaModel`
    coefficients from measurement samples, returning a new `ArchSpec`
    whose energy numbers come from the fit instead of Table-2 constants.

    `samples`: dict mapping level name -> (kb, c_pe, pj) arrays; levels
    absent from the dict keep their shipped model.  `samples=None` fits
    every level with a capacity-dependent EPA (slope != 0) against the
    deterministic `measured_epa_samples` table."""
    if samples is None:
        samples = {lvl.name: measured_epa_samples(spec, i)
                   for i, lvl in enumerate(spec.levels)
                   if lvl.epa.slope != 0.0}
    unknown = set(samples) - {lvl.name for lvl in spec.levels}
    if unknown:
        raise ValueError(f"no levels named {sorted(unknown)} in "
                         f"{spec.name} "
                         f"(has {[lvl.name for lvl in spec.levels]})")
    levels = []
    for lvl in spec.levels:
        if lvl.name in samples:
            kb, c_pe, pj = samples[lvl.name]
            # The spec DECLARES each level's EPA structure; calibration
            # fits its coefficients.  Auto-selecting pe_scaled here
            # would be unidentifiable on constant-c_pe tables (the two
            # designs are collinear, so float noise decides) and could
            # silently flip a level's capacity scaling law.
            fitted = EpaModel.fit(kb, c_pe, pj,
                                  pe_scaled=lvl.epa.pe_scaled)
            lvl = dataclasses.replace(lvl, epa=fitted)
        levels.append(lvl)
    return dataclasses.replace(spec, levels=tuple(levels))


# ---------------------------------------------------------------------------
# Dataset generation + persistence
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationDataset:
    """Labeled random-mapping samples of one spec: the Sec. 6.5.1
    training set (the paper uses 1567 FireSim measurements)."""

    spec_name: str
    features: np.ndarray     # (N, n_features)
    analytical: np.ndarray   # (N,) analytical latency, cycles
    target: np.ndarray       # (N,) measured ("RTL") latency, cycles
    layer_idx: np.ndarray    # (N,) source layer index

    def __len__(self) -> int:
        return len(self.features)

    def save(self, path) -> None:
        np.savez(path, spec_name=np.asarray(self.spec_name),
                 features=self.features, analytical=self.analytical,
                 target=self.target, layer_idx=self.layer_idx)

    @classmethod
    def load(cls, path) -> "CalibrationDataset":
        with np.load(path, allow_pickle=False) as d:
            return cls(spec_name=str(d["spec_name"]),
                       features=d["features"], analytical=d["analytical"],
                       target=d["target"], layer_idx=d["layer_idx"])


def default_hw_for(spec) -> HWConfig:
    """A mid-range concrete hardware point for dataset labeling: the
    spec's `default_hw` if declared, else the geometric middle of its
    random-start ranges (PE side and each searched level's capacity)."""
    cspec = resolve_spec(spec)
    s = cspec.spec
    if s.default_hw is not None:
        return s.default_hw
    lo, hi = s.rand_pe_log2
    pe = s.fixed_pe_dim or min(int(2 ** ((lo + hi) // 2)), cspec.pe_cap)
    kbs = []
    for i in cspec.searched_levels:
        klo, khi = s.levels[i].rand_log2_kb or (3, 12)
        kbs.append(float(2 ** ((klo + khi) // 2)))
    return HWConfig(pe_dim=pe, cap_kb=tuple(kbs))


def build_calibration_dataset(layers, hw=None, spec=None,
                              n_per_layer: int = 40, seed: int = 0,
                              target_fn=None) -> CalibrationDataset:
    """Sample random valid mappings per layer on any spec and label them
    with analytical + measured latency.  `target_fn(m, layer, hw)`
    overrides the label source (default: the spec-generic RTL stand-in);
    invalid mappings are skipped, mirroring the paper's valid-sample
    protocol."""
    cspec = resolve_spec(spec)
    hw = default_hw_for(cspec) if hw is None else hw
    if target_fn is None:
        def target_fn(m, layer, h):
            return rtl_latency(m, layer, h, spec=cspec)

    rng = np.random.default_rng(seed)
    feats, ana, tgt, idx = [], [], [], []
    for li, layer in enumerate(layers):
        got, tries = 0, 0
        while got < n_per_layer and tries < 50 * n_per_layer:
            tries += 1
            m = random_mapping(np.asarray(layer.dims), rng,
                               max_pe_dim=hw.pe_dim, spec=cspec)
            r = evaluate(m, layer, hw=hw, spec=cspec)
            if not r.valid:
                continue
            lat = target_fn(m, layer, hw)
            if not np.isfinite(lat):
                continue
            feats.append(featurize_spec(m, layer, hw, spec=cspec))
            ana.append(r.latency)
            tgt.append(lat)
            idx.append(li)
            got += 1
    return CalibrationDataset(
        spec_name=cspec.spec.name, features=np.asarray(feats),
        analytical=np.asarray(ana), target=np.asarray(tgt),
        layer_idx=np.asarray(idx, dtype=np.int64))


# ---------------------------------------------------------------------------
# The calibration bundle: fitted EPA + trained model + metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Calibration:
    """Everything needed to search a spec through measurement: the
    EPA-calibrated `ArchSpec`, the trained residual latency model, and
    the fit metrics.  Saves to a directory (EPA coefficients + metrics
    as JSON, model weights as npz)."""

    spec: ArchSpec
    model: TrainedModel
    metrics: dict

    def save(self, out_dir) -> Path:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.model.save(out / "model.npz")
        payload = {
            "spec": self.spec.name,
            "epa": [{"level": lvl.name, "base": lvl.epa.base,
                     "slope": lvl.epa.slope,
                     "pe_scaled": lvl.epa.pe_scaled,
                     "source": lvl.epa.source}
                    for lvl in self.spec.levels],
            "metrics": self.metrics,
        }
        with open(out / "calibration.json", "w") as f:
            json.dump(payload, f, indent=1, default=float)
        return out

    @classmethod
    def load(cls, base_spec: ArchSpec, out_dir,
             device=DEFAULT_DEVICE) -> "Calibration":
        """Rebuild from artifacts: re-applies the saved per-level EPA
        coefficients to `base_spec` (matched by level name) and loads
        the model weights onto `device`."""
        out = Path(out_dir)
        with open(out / "calibration.json") as f:
            payload = json.load(f)
        if payload["spec"] != base_spec.name:
            raise ValueError(f"artifact calibrates {payload['spec']!r}, "
                             f"got base spec {base_spec.name!r}")
        by_name = {e["level"]: e for e in payload["epa"]}
        levels = []
        for lvl in base_spec.levels:
            e = by_name.get(lvl.name)
            if e is not None:
                lvl = dataclasses.replace(lvl, epa=EpaModel(
                    float(e["base"]), float(e["slope"]),
                    bool(e["pe_scaled"]), source=str(e["source"])))
            levels.append(lvl)
        spec = dataclasses.replace(base_spec, levels=tuple(levels))
        return cls(spec=spec,
                   model=TrainedModel.load(out / "model.npz", device=device),
                   metrics=payload["metrics"])


def calibrate(spec: ArchSpec, layers, hw=None, n_per_layer: int = 40,
              seed: int = 0, epochs: int = 200,
              epa_samples=None, dataset: CalibrationDataset | None = None,
              val_frac: float = 0.2, device=DEFAULT_DEVICE) -> Calibration:
    """The full calibration pipeline for one spec: sample random
    mappings -> label with the measured target -> fit EPA coefficients
    -> train the residual latency model -> report metrics (held-out
    Spearman vs. the analytical model, validation MSE); the model
    trains on `device`.  The returned
    bundle's `spec` + `model` plug straight into
    `SearchConfig(spec=..., surrogate=...)`."""
    cspec = resolve_spec(spec)
    hw = default_hw_for(cspec) if hw is None else hw
    if dataset is None:
        dataset = build_calibration_dataset(layers, hw, spec=cspec,
                                            n_per_layer=n_per_layer,
                                            seed=seed)
    if len(dataset) < 8:
        raise ValueError(f"calibration dataset too small "
                         f"({len(dataset)} valid samples)")
    n = len(dataset)
    te = np.arange(n) % max(int(1 / max(val_frac, 1e-6)), 2) == 0
    tr = ~te
    model = train_residual_model(
        dataset.features[tr], dataset.analytical[tr], dataset.target[tr],
        epochs=epochs, seed=seed, spec_name=cspec.spec.name,
        device=device)
    pred = model.predict_latency(dataset.features[te],
                                 dataset.analytical[te])
    metrics = {
        "n_samples": int(n),
        "spearman_analytical": spearman(dataset.analytical[te],
                                        dataset.target[te]),
        "spearman_combined": spearman(pred, dataset.target[te]),
        "val_mse": float(model.val_mse),
    }
    return Calibration(spec=calibrate_epa(spec, samples=epa_samples),
                       model=model, metrics=metrics)


def predicted_edp_fn(model: TrainedModel, spec=None, pe_dim=None):
    """`(mappings, workload) -> predicted EDP` through the learned
    latency model + analytical energy, buffers re-derived minimally —
    the spec-generic oracle stand-in for searching against a learned
    target (`SearchConfig.latency_model`).  `pe_dim` pins the PE side
    (the Sec. 6.5 frozen-array protocol)."""
    cspec = resolve_spec(spec)
    check_surrogate(model, cspec)

    def fn(mappings, workload):
        hw = minimal_hw_for(cspec, mappings, list(workload.layers))
        if pe_dim is not None and cspec.spec.fixed_pe_dim is None:
            hw = dataclasses.replace(hw, pe_dim=pe_dim)
        e_tot, l_tot = 0.0, 0.0
        for m, layer in zip(mappings, workload.layers):
            r = evaluate(m, layer, hw=hw, spec=cspec)
            if not r.valid:
                return float("inf")
            f = featurize_spec(m, layer, hw, spec=cspec)[None]
            lat = model.predict_latency(f, np.array([r.latency]))[0]
            e_tot += r.energy * layer.repeat
            l_tot += lat * layer.repeat
        return e_tot * l_tot
    return fn
