"""Problem (workload) algebra for DOSA.

A DNN layer is described by the 7 canonical dimensions of Timeloop/DOSA
(Sec. 3.1.1 of the paper):

    R  weight height          S  weight width
    P  output height          Q  output width
    C  input channels         K  output channels
    N  batch size

Matrix multiplications are 1x1 convolutions (R=S=1, Q=1):
    out[M, N_g] = sum_K a[M, K_g] b[K_g, N_g]  ->  P=M, C=K_g, K=N_g.

A `Workload` is a list of layers with repeat counts (Sec. 4.5: layers that
appear multiple times share a mapping; energy/latency are scaled by count).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

# Canonical dimension order. Index into every per-dim array.
DIMS = ("R", "S", "P", "Q", "C", "K", "N")
R, S, P, Q, C, K, N = range(7)
NDIMS = 7

# Tensor index order: W, I, O.
TENSORS = ("W", "I", "O")
W_T, I_T, O_T = range(3)
NTENSORS = 3

# Relevance masks (D_W, D_I, D_O from Sec. 4.1.1).  D_I nominally includes
# R and S; they enter the input-tile size only through the sliding-window
# extents (Eq. 3), so the direct-product mask for inputs is {C, N} and the
# window handles P/Q/R/S.  For *relevance* (reuse analysis) R and S do
# index the input tensor, so the relevance mask includes them.
REL = np.zeros((NTENSORS, NDIMS), dtype=bool)
REL[W_T, [R, S, C, K]] = True
REL[I_T, [R, S, P, Q, C, N]] = True
REL[O_T, [P, Q, K, N]] = True

# Direct-product dims for tile-size computation (window dims excluded for I).
SIZE_DIMS = np.zeros((NTENSORS, NDIMS), dtype=bool)
SIZE_DIMS[W_T, [R, S, C, K]] = True
SIZE_DIMS[I_T, [C, N]] = True
SIZE_DIMS[O_T, [P, Q, K, N]] = True


@dataclasses.dataclass(frozen=True)
class Layer:
    """One conv / matmul layer in the 7-dim space."""

    dims: tuple[int, int, int, int, int, int, int]  # (R,S,P,Q,C,K,N)
    wstride: int = 1  # Pstride
    hstride: int = 1  # Qstride
    repeat: int = 1   # times this layer appears in the network
    name: str = "layer"

    def __post_init__(self):
        if len(self.dims) != NDIMS:
            raise ValueError(f"need {NDIMS} dims, got {self.dims}")
        if any(d < 1 for d in self.dims):
            raise ValueError(f"dims must be >= 1: {self.dims}")

    @property
    def macs(self) -> int:
        return int(np.prod([int(d) for d in self.dims], dtype=object))

    def tensor_sizes(self) -> tuple[int, int, int]:
        """Full W / I / O tensor sizes in words."""
        r, s, p, q, c, k, n = self.dims
        w = r * s * c * k
        pin = self.wstride * (p - 1) + r
        qin = self.hstride * (q - 1) + s
        i = c * n * pin * qin
        o = p * q * k * n
        return w, i, o

    @staticmethod
    def matmul(m: int, n_g: int, k_g: int, batch: int = 1, repeat: int = 1,
               name: str = "matmul") -> "Layer":
        """GEMM out[M, N_g] = A[M, K_g] @ B[K_g, N_g], `batch` independent
        problems sharing B (weights)."""
        return Layer(dims=(1, 1, m, 1, k_g, n_g, batch), repeat=repeat,
                     name=name)

    @staticmethod
    def conv(c_in: int, c_out: int, kernel: int, out_hw: int, stride: int = 1,
             batch: int = 1, repeat: int = 1, name: str = "conv") -> "Layer":
        return Layer(dims=(kernel, kernel, out_hw, out_hw, c_in, c_out,
                           batch),
                     wstride=stride, hstride=stride, repeat=repeat, name=name)


@dataclasses.dataclass(frozen=True)
class Workload:
    """A network = unique layers + repeat counts."""

    layers: tuple[Layer, ...]
    name: str = "workload"

    def __post_init__(self):
        if not self.layers:
            raise ValueError("empty workload")

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def total_macs(self) -> int:
        return sum(lay.macs * lay.repeat for lay in self.layers)

    def dims_array(self) -> np.ndarray:
        """(L, 7) int array of problem dims."""
        return np.array([lay.dims for lay in self.layers], dtype=np.int64)

    def strides_array(self) -> np.ndarray:
        """(L, 2) [wstride, hstride]."""
        return np.array([[lay.wstride, lay.hstride]
                         for lay in self.layers],
                        dtype=np.int64)

    def repeats_array(self) -> np.ndarray:
        return np.array([lay.repeat for lay in self.layers],
                        dtype=np.int64)


def divisors(n: int) -> list[int]:
    """Sorted divisors of n."""
    small, large = [], []
    for i in range(1, int(math.isqrt(n)) + 1):
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
    return small + large[::-1]


def dedupe_layers(layers: Sequence[Layer]) -> Workload:
    """Collapse identical (dims, strides) layers into repeats."""
    seen: dict[tuple, int] = {}
    order: list[Layer] = []
    for lay in layers:
        key = (lay.dims, lay.wstride, lay.hstride)
        if key in seen:
            idx = seen[key]
            old = order[idx]
            order[idx] = dataclasses.replace(
                old, repeat=old.repeat + lay.repeat)
        else:
            seen[key] = len(order)
            order.append(lay)
    return Workload(layers=tuple(order))
