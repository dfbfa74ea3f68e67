"""Deterministic RTL-measurement stand-in (for the paper's FireSim runs).

The PyTorch port's own copy of the reference module
(`repro.core.rtl_sim`): host numpy, held to it number for number by
`tests/test_torch_calibration.py`.

Spec-generic: `rtl_latency(..., spec=s)` distorts any `ArchSpec`
target's analytical latency (level indices — accumulation, input
staging, backing store — are read from the compiled spec), so the
calibration subsystem (`core/calibration.py`) can label datasets for
every target.  The default is the original "Gemmini-RTL", bit-identical
to the pre-spec implementation.

The paper evaluates real-hardware latency with FireSim RTL simulation
(Sec. 6.5).  Offline we substitute a *structured distortion* of the
analytical model that injects exactly the effect classes the paper
attributes to real hardware ("specific implementation details and
complex hardware-software interactions"):

  1. systolic-array ramp-up/drain: a fixed pipeline-fill cost per
     accumulator-tile dispatch (rows+cols cycles each);
  2. DMA burst quantization: DRAM traffic rounded up to 64-byte bursts;
  3. sub-unit utilization at small tiles: throughput derates when the
     spatial mapping leaves PE rows/columns idle (beyond the analytical
     MACs/PE term, the RTL loses extra cycles to control);
  4. load/drain serialization: a fraction of scratchpad traffic does
     not overlap with compute;
  5. deterministic per-mapping pseudo-noise (~4%), seeded from the
     mapping bits, standing in for measurement/NoC jitter.

The resulting "RTL" latency correlates with — but systematically and
nonlinearly deviates from — the analytical model, which is precisely the
regime the paper's DNN-augmented model targets.  All constants are
fixed; the function is a *deterministic oracle*, so experiments are
reproducible.
"""
from __future__ import annotations

import hashlib

import numpy as np

from .arch import GemminiHW
from .archspec import resolve_spec
from .mapping import SPATIAL, Mapping
from .oracle import evaluate
from .problem import I_T, O_T, W_T, Layer

BURST_WORDS = 64
RAMP_CYCLES_PER_DISPATCH = 12.0    # x (rows + cols)
DMA_SETUP_CYCLES = 120.0           # per accumulator-tile dispatch
NONOVERLAP_FRACTION = 0.6          # of scratchpad load cycles
CONTROL_DERATE = 1.5               # extra cost x (1 - utilization)^2
MISALIGN_PENALTY = 0.35            # tile width not a PE-row multiple
NOISE_AMPLITUDE = 0.10


def _mapping_noise(m: Mapping, layer: Layer) -> float:
    """Deterministic multiplicative jitter in [1-A, 1+A]."""
    h = hashlib.sha256()
    h.update(np.asarray(m.f, dtype=np.float64).tobytes())
    h.update(np.asarray(m.order, dtype=np.int64).tobytes())
    h.update(np.asarray(layer.dims, dtype=np.int64).tobytes())
    u = int.from_bytes(h.digest()[:8], "little") / 2 ** 64
    return 1.0 + NOISE_AMPLITUDE * (2.0 * u - 1.0)


def rtl_latency(m: Mapping, layer: Layer, hw, spec=None) -> float:
    """Cycle count of the simulated RTL for one layer mapping on any
    `ArchSpec` target (default Gemmini — bit-identical to the original
    Gemmini-only implementation there).  The distortion classes read
    their level indices from the compiled spec: the accumulation level
    (output drains), the innermost input-staging level ("scratchpad"),
    and the backing store.  Returns inf for invalid mappings (same
    validity rules as the oracle)."""
    cspec = resolve_spec(spec)
    r = evaluate(m, layer, hw=hw, quantize_dram=True, spec=cspec)
    if not r.valid:
        return float("inf")

    acc_lvl = cspec.tensor_levels[O_T][0]     # accumulation level
    sp_lvl = cspec.tensor_levels[I_T][0]      # input staging level
    backing = cspec.backing
    c_pe, _ = cspec.hw_words(hw)
    # One hardware point per sample: fixed-silicon specs pin the array
    # side (consistent with c_pe above), else the hardware point's.
    pe_dim = cspec.spec.fixed_pe_dim or hw.pe_dim

    macs = layer.macs
    utilized = 1
    for (lvl, d) in cspec.spatial_sites:
        utilized *= max(int(round(m.f[SPATIAL, lvl, d])), 1)
    util = utilized / c_pe

    # 1. ramp-up/drain + DMA setup per accumulator-tile dispatch:
    # mappings with many small output tiles pay heavily in RTL.
    acc_tile = max(float(r.caps[acc_lvl, O_T]), 1.0)
    total_out = float(r.caps[backing, O_T])
    dispatches = max(total_out / acc_tile, 1.0)
    ramp = (RAMP_CYCLES_PER_DISPATCH * (pe_dim * 2)
            + DMA_SETUP_CYCLES) * dispatches

    # 2. DMA bursts: extra backing-store cycles from burst padding.
    bw = cspec.bandwidth(float(c_pe))
    dram_words = float(r.accesses[backing])
    burst_words = np.ceil(dram_words / BURST_WORDS) * BURST_WORDS
    dma_extra = (burst_words - dram_words) / bw[backing]

    # 3. control overhead at low spatial utilization (quadratic: very
    # small tiles never reach steady state in the array).
    compute_cycles = macs / utilized
    control = CONTROL_DERATE * (1.0 - util) ** 2 * compute_cycles

    # 4. non-overlapped staging-buffer loads.
    sp_cycles = float(r.accesses[sp_lvl]) / bw[sp_lvl]
    serial = NONOVERLAP_FRACTION * sp_cycles

    # 5. row-misalignment: accumulator tile width not a multiple of the
    # array edge leaves bubbles in the drain path.
    align = acc_tile % pe_dim
    misalign = MISALIGN_PENALTY * (align / pe_dim) * compute_cycles

    # 6. bank-conflict / alignment resonances: smooth, deterministic,
    # non-monotone functions of the tile geometry (stand-in for SRAM
    # banking and NoC interactions real RTL exhibits).  Learnable from
    # mapping features by the DNN, invisible to the analytical model.
    sp_tile = max(float(r.caps[sp_lvl, W_T] + r.caps[sp_lvl, I_T]), 1.0)
    phase = (0.80 * np.sin(np.pi * np.log2(acc_tile) / 5.0)
             + 0.60 * np.cos(np.pi * np.log2(sp_tile) / 6.0)
             + 0.40 * np.sin(2.0 * np.pi * util))
    resonance = float(np.exp(phase))

    lat = (r.latency + ramp + dma_extra + control + serial
           + misalign) * resonance
    return float(lat * _mapping_noise(m, layer))


def build_dataset(layers, hw: GemminiHW, n_per_layer: int, seed: int = 0):
    """Random-mapping latency dataset a la Sec. 6.5.1 (the paper's 1567
    FireSim samples): returns (features, analytical_latency,
    rtl_latency, layer_index) for valid mappings only.  Legacy Gemmini
    entry point — a tuple view of the spec-generic
    `calibration.build_calibration_dataset` (same seeded sampling
    protocol, bit-identical Gemmini features/labels)."""
    from .calibration import build_calibration_dataset

    ds = build_calibration_dataset(layers, hw, n_per_layer=n_per_layer,
                                   seed=seed)
    return ds.features, ds.analytical, ds.target, ds.layer_idx


def rtl_workload_edp(mappings, layers, hw, spec=None):
    """EDP with RTL latency + analytical energy — the paper's Sec. 6.5
    composition (FireSim latency, Timeloop/Accelergy energy).  `spec`
    selects the target architecture (default Gemmini)."""
    e_tot, l_tot = 0.0, 0.0
    for m, layer in zip(mappings, layers):
        lat = rtl_latency(m, layer, hw, spec=spec)
        r = evaluate(m, layer, hw=hw, spec=spec)
        if not np.isfinite(lat) or not r.valid:
            return float("inf")
        e_tot += r.energy * layer.repeat
        l_tot += lat * layer.repeat
    return e_tot * l_tot
