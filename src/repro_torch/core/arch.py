"""Accelerator architecture descriptions.

Two targets:

* `GEMMINI` — the paper's accelerator-under-study (Table 2 / Table 4):
  a weight-stationary systolic array with per-PE weight registers, an
  output accumulator SRAM, a shared scratchpad SRAM for weights+inputs,
  and DRAM.

* `TPU_V5E` — the hardware-adaptation target (DESIGN.md Sec. 5): the same
  modeling framework retargeted at the TPU v5e memory hierarchy
  (HBM -> VMEM -> VREG/MXU) where capacities are *fixed constraints*
  rather than search outputs.  Used by `core/tpu_model.py`.

Units: capacities in *words*; energy-per-access in pJ/word (Table 2 gives
"uJ" but the values are the standard 40nm pJ-class numbers — units cancel
in EDP ratios).  The capacity-dependent SRAM EPA terms take capacities in
KB (C_i_words * word_bytes / 1024), which reproduces sane magnitudes
relative to the DRAM 100 pJ/word constant.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .problem import NTENSORS, W_T, I_T, O_T

# ---------------------------------------------------------------------------
# Gemmini (paper Table 2 / Table 4)
# ---------------------------------------------------------------------------

# Memory level indices.
REG, ACC, SP, DRAM = range(4)
NLEVELS = 4
LEVEL_NAMES = ("Registers", "Accumulator", "Scratchpad", "DRAM")

# Binary matrix B (Table 4): B[level, tensor] — which tensor lives where.
B_GEMMINI = np.zeros((NLEVELS, NTENSORS), dtype=bool)
B_GEMMINI[REG, W_T] = True
B_GEMMINI[ACC, O_T] = True
B_GEMMINI[SP, W_T] = True
B_GEMMINI[SP, I_T] = True
B_GEMMINI[DRAM, :] = True

# Energy per access constants (Table 2).
EPA_MAC = 0.561
EPA_REG = 0.487
EPA_ACC_BASE, EPA_ACC_SLOPE = 1.94, 0.1005  # + slope * C_acc_KB / sqrt(C_PE)
EPA_SP_BASE, EPA_SP_SLOPE = 0.49, 0.025        # + slope * C_sp_KB
EPA_DRAM = 100.0

# Word sizes in bytes (Gemmini: int8 datapath, 32-bit partial sums).
WORD_BYTES = np.array([1.0, 4.0, 1.0, 1.0])  # per level REG, ACC, SP, DRAM

# DRAM bandwidth, words/cycle (Table 2).
DRAM_BW = 8.0

# DRAM block size in words — Timeloop quantizes DRAM traffic to blocks
# (the source of the paper's Fig. 4 small-layer outliers).  The oracle
# applies ceil-to-block; the differentiable model does not.
DRAM_BLOCK_WORDS = 8

# Search bounds.
MAX_PE_DIM = 128          # PE array capped at 128x128 (Sec. 6.1)
SRAM_ROUND_BYTES = 1024   # SRAM sizes rounded up to 1 KB increments


@dataclasses.dataclass(frozen=True)
class GemminiHW:
    """A concrete Gemmini hardware configuration (the DSE output)."""

    pe_dim: int          # systolic array is pe_dim x pe_dim
    acc_kb: float        # accumulator SRAM capacity, KB
    sp_kb: float         # scratchpad SRAM capacity, KB

    @property
    def c_pe(self) -> int:
        return self.pe_dim * self.pe_dim

    @property
    def acc_words(self) -> float:
        return self.acc_kb * 1024.0 / WORD_BYTES[ACC]

    @property
    def sp_words(self) -> float:
        return self.sp_kb * 1024.0 / WORD_BYTES[SP]

    def as_vector(self) -> np.ndarray:
        return np.array([self.pe_dim, self.acc_kb, self.sp_kb], dtype=float)


# Default Gemmini config (Sec. 6.5: 16x16 PEs, 32 KB acc, 128 KB sp,
# single-buffered accounting).
GEMMINI_DEFAULT = GemminiHW(pe_dim=16, acc_kb=32.0, sp_kb=128.0)

# Expert-designed baseline accelerators for Fig. 8, expressed as
# Gemmini-class configs (Gemmini-class proxies with published PE counts
# / on-chip SRAM budgets).
BASELINE_ACCELS = {
    "eyeriss": GemminiHW(pe_dim=13, acc_kb=24.0, sp_kb=108.0),
    "nvdla_small": GemminiHW(pe_dim=8, acc_kb=32.0, sp_kb=128.0),
    "nvdla_large": GemminiHW(pe_dim=32, acc_kb=128.0, sp_kb=512.0),
    "gemmini_default": GEMMINI_DEFAULT,
}


def bandwidth_words_per_cycle(c_pe):
    """Per-level bandwidth in words/cycle [REG, ACC, SP, DRAM] (Table 2)
    for Python scalars, numpy arrays or torch tensors `c_pe`, from the
    compiled `GEMMINI_SPEC` (archspec.py), the single source of the
    per-level bandwidth models."""
    from .archspec import GEMMINI_SPEC, compile_spec
    return compile_spec(GEMMINI_SPEC).bandwidth(c_pe)


def epa_per_level(c_pe, acc_words, sp_words):
    """Per-level energy/access [REG, ACC, SP, DRAM] given hardware params
    (capacity-dependent SRAM EPA, Table 2), from the compiled
    `GEMMINI_SPEC`, the single source of the EPA models."""
    from .archspec import GEMMINI_SPEC, compile_spec
    return compile_spec(GEMMINI_SPEC).epa(
        c_pe, [0.0, acc_words, sp_words, 0.0])

# ---------------------------------------------------------------------------
# TPU v5e adaptation target (DESIGN.md Sec. 5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUTarget:
    """Fixed TPU v5e per-chip hardware constants for the adapted model and
    the roofline analysis."""

    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s
    ici_bw: float = 50e9                # bytes/s per link
    vmem_bytes: float = 128 * 1024 ** 2  # ~128 MiB VMEM
    mxu_dim: int = 128                  # systolic array is 128x128
    hbm_bytes: float = 16 * 1024 ** 3   # 16 GiB HBM


TPU_V5E = TPUTarget()

# NVIDIA H100 SXM, the card the port runs on, as a roofline target of
# the dry-run and the hillclimb (`step_roofline(..., target=H100_SXM)`):
# the data sheet's dense bf16 peak and HBM3 rate at the 700 W limit,
# NVLink 4's rate per direction, 80 GB of HBM, the 227 KB of shared
# memory one block can take (the counterpart of VMEM) and a wgmma's M.
# Only the roofline reads it: `tpu_model.matmul_latency`'s block-cost
# model is calibrated for the TPU v5e, not for this target (a Hopper
# block-cost model is an open question).
H100_SXM = TPUTarget(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                     vmem_bytes=227 * 1024, mxu_dim=64, hbm_bytes=80e9)
