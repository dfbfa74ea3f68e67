"""DOSA's differentiable model retargeted at the TPU v5e memory
hierarchy, on torch tensors: the block-cost model the matmul autotuner
descends, and the step-level three-term roofline of the dry-run.

The PyTorch port of `repro.core.tpu_model`, ported as-is for parity:
the TPU v5e is `archspec.TPU_V5E_SPEC` (HBM -> VMEM -> VREG/MXU with
*fixed* capacities), and `matmul_latency` / `vmem_footprint` express a
matmul tile schedule (bm, bn, bk) as a mapping tensor for the shared
differentiable core in `model.py`.  It prices a TPU, not the H100 the
port runs on: its blocks do not steer the CUDA kernel's tiling until a
Hopper block-cost model exists (ROADMAP, open questions).

Block sizes may be Python numbers or float32 tensors of any shape (a
batch of candidate schedules evaluates in one call).  Division by a
tensor is written `torch.div(tensor, tensor)`: `scalar / tensor` in
torch multiplies by a reciprocal, which rounds differently from the
reference's division.
"""
from __future__ import annotations

import dataclasses

import torch

from .arch import TPU_V5E, TPUTarget
from .archspec import TPU_V5E_SPEC, compile_spec
from .mapping import OS_ORD, TEMPORAL
from .model import capacities, relu, traffic_spec
from .problem import C as C_D, K as K_D, P as P_D, I_T, O_T, W_T

_STRIDES = (1.0, 1.0)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _div(a, b, like: torch.Tensor) -> torch.Tensor:
    """a / b in float32 with IEEE division, either side a Python
    number or a tensor."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, float(a))
    return a / b


def smooth_ceil(x: torch.Tensor) -> torch.Tensor:
    """ceil with pass-through gradient of identity (ceil(x) >= x)."""
    return x + (torch.ceil(x) - x).detach()


def mxu_utilization(bm, bn, bk, target: TPUTarget = TPU_V5E):
    """Fractional MXU occupancy of a (bm, bk) x (bk, bn) tile: last dim
    packs into 128 lanes, second-to-last into 8 sublanes; the MXU
    contracts 128 at a time.  bm, bn, bk: float32 tensors."""
    lane = target.mxu_dim
    util_n = bn / (smooth_ceil(bn / lane) * lane)
    util_k = bk / (smooth_ceil(bk / lane) * lane)
    util_m = bm / (smooth_ceil(bm / 8.0) * 8.0)
    return util_m * util_n * util_k


def _factor_tensor(cells: dict, like: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3, 7) factor tensor, ones except the given
    (k, level, dim) -> tensor cells."""
    one = torch.ones_like(like)
    flat = [cells.get((k, lvl, d), one).expand_as(like)
            for k in range(2) for lvl in range(3) for d in range(7)]
    return torch.stack(flat, dim=-1).reshape(like.shape + (2, 3, 7))


def _tile_factors(m, n, k, bm, bn, bk):
    """(..., 2, 3, 7) factor tensor of the (bm, bn, bk) schedule on the
    TPU spec's VREG/VMEM/HBM hierarchy: VMEM holds one (possibly
    clamped) tile per operand, HBM carries the smooth-ceil grid loops."""
    grid_m = smooth_ceil(_div(m, bm, bm))
    grid_n = smooth_ceil(_div(n, bn, bn))
    grid_k = smooth_ceil(_div(k, bk, bk))
    return _factor_tensor({
        (TEMPORAL, 1, P_D): _div(m, grid_m, grid_m),
        (TEMPORAL, 1, K_D): _div(n, grid_n, grid_n),
        (TEMPORAL, 1, C_D): _div(k, grid_k, grid_k),
        (TEMPORAL, 2, P_D): grid_m,
        (TEMPORAL, 2, K_D): grid_n,
        (TEMPORAL, 2, C_D): grid_k,
    }, grid_m)


def matmul_latency(m, n, k, bm, bn, bk, dtype_bytes: float = 2.0,
                   target: TPUTarget = TPU_V5E):
    """Differentiable latency (seconds) + aux terms for matmul tile
    schedules on one TPU v5e chip.  bm, bn, bk: float32 tensors of one
    shape.  HBM traffic comes from the shared DOSA traffic model
    (Eqs. 6-11) on the TPU spec's hierarchy; compute from the MXU
    occupancy model."""
    cspec = compile_spec(TPU_V5E_SPEC)
    dev = bm.device
    f = _tile_factors(m, n, k, bm, bn, bk)
    # K-innermost output-stationary HBM loop order (kernels/matmul).
    order = torch.tensor([0, 0, OS_ORD], device=dev)
    caps = capacities(f, _f32(_STRIDES, dev))
    macs = torch.full_like(bm, float(m) * float(n) * float(k))
    tr = traffic_spec(cspec, f, order, caps, macs)
    hbm_words = tr.accesses[..., cspec.backing] + m * n  # + downstream read
    hbm_bytes = hbm_words * dtype_bytes
    compute_s = _div(2.0 * m * n * k,
                     target.peak_flops * mxu_utilization(bm, bn, bk, target),
                     bm)
    memory_s = hbm_bytes / _f32(target.hbm_bw, dev)
    latency = torch.maximum(compute_s, memory_s)
    return latency, {"compute_s": compute_s, "memory_s": memory_s,
                     "hbm_bytes": hbm_bytes}


def vmem_footprint(bm, bn, bk, dtype_bytes: float = 2.0):
    """Double-buffered input tiles + f32 accumulator (bytes), from the
    shared capacity model (Eqs. 2-5) at the VMEM level."""
    f = _factor_tensor({(TEMPORAL, 1, P_D): bm, (TEMPORAL, 1, K_D): bn,
                        (TEMPORAL, 1, C_D): bk}, bm)
    caps = capacities(f, _f32(_STRIDES, bm.device))
    return (2.0 * (caps[..., 1, W_T] + caps[..., 1, I_T]) * dtype_bytes
            + caps[..., 1, O_T] * 4.0)


def vmem_penalty(bm, bn, bk, dtype_bytes: float = 2.0,
                 target: TPUTarget = TPU_V5E):
    """Relative VMEM overflow — the inverted Eq. 2-5 constraint."""
    return relu(vmem_footprint(bm, bn, bk, dtype_bytes)
                / _f32(target.vmem_bytes, bm.device) - 1.0)


# ---------------------------------------------------------------------------
# Step-level three-term roofline (the dry-run's; `launch.hillclimb`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def step_roofline(flops_per_dev: float, bytes_per_dev: float,
                  coll_bytes_per_dev: float,
                  target: TPUTarget = TPU_V5E) -> RooflineTerms:
    """Three roofline terms from the dry-run's per-device counts:

      compute    = FLOPs / peak
      memory     = bytes / HBM rate
      collective = collective bytes / link rate

    The default target is the reference's (`TPU_V5E`); the port's
    dry-run and hillclimb pass `arch.H100_SXM`."""
    return RooflineTerms(
        compute_s=flops_per_dev / target.peak_flops,
        memory_s=bytes_per_dev / target.hbm_bw,
        collective_s=coll_bytes_per_dev / target.ici_bw,
    )


def model_flops(n_active_params: float, tokens: float,
                train: bool) -> float:
    """6*N*D (train) / 2*N*D (inference) useful-FLOPs accounting."""
    per_tok = 6.0 * n_active_params if train else 2.0 * n_active_params
    return per_tok * tokens
