"""Tiled matmul: the Hopper CUDA kernel (``kernels/csrc/matmul.cu``)
behind the reference's signature.

The port of `repro.kernels.matmul.matmul` (the Pallas TPU kernel
`_matmul_kernel`).  `matmul(x, y, bm=, bk=, bn=)` keeps the reference's
checks — blocks are clipped to the problem with `min` and must divide
it — but the CUDA kernels tile with their own fixed Hopper tiles: the
TPU-tuned blocks are VMEM tiles far larger than a block's 227 KB of
shared memory, and they do not steer the CUDA tiling until a Hopper
block-cost model exists.

Two kernels, chosen by `variant(m, k, n, dtype)` from shape and type
alone: "wgmma" (tensor cores, TMA; 128 x 256 outputs per block) for
bfloat16 with K and N multiples of 8 — TMA needs 16-byte row strides —
and "simt" (IEEE float32 FMA; 64 x 64 outputs per block) for float32
and for the other bfloat16 shapes.

A CPU tensor goes through the plain version (`ref.matmul_ref`); a CUDA
tensor always launches its variant's kernel or raises.
`matmul.launches` counts the kernel launches, and
`matmul.launches_by_variant` counts them per variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .ref import matmul_ref

_ENTRY = {("simt", torch.float32): "repro_matmul_f32",
          ("simt", torch.bfloat16): "repro_matmul_bf16",
          ("wgmma", torch.bfloat16): "repro_matmul_bf16_wgmma"}


def variant(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The kernel an (m, k) @ (k, n) product of `dtype` runs on:
    "wgmma" for bfloat16 with K % 8 == 0 and N % 8 == 0 (16-byte row
    strides for TMA), else "simt"."""
    del m  # TMA zero-fills any ragged M
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..build import load

    lib = load("matmul")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, y: torch.Tensor, bm: int, bk: int, bn: int):
    """The reference's shape/block checks plus what the kernel needs;
    returns the clipped blocks."""
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    m, k = x.shape
    k2, n = y.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if min(m, k, n) < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or y.dtype != x.dtype:
        raise TypeError(f"matmul takes float32 or bfloat16 operands of one "
                        f"type, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul takes contiguous (row-major) operands")
    bm, bk, bn = min(bm, m), min(bk, k), min(bn, n)
    if m % bm or k % bk or n % bn:
        raise ValueError(f"blocks (bm={bm}, bk={bk}, bn={bn}) must divide "
                         f"the problem (m={m}, k={k}, n={n})")
    return bm, bk, bn


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 256,
           bk: int = 512, bn: int = 256) -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x.dtype, accumulated in
    IEEE float32.  Block shapes must divide the problem (after clipping
    to it), as in the reference."""
    _check(x, y, bm, bk, bn)
    if x.device.type == "cpu":
        return matmul_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cpu or cuda, not {x.device}")
    m, k = x.shape
    n = y.shape[1]
    var = variant(m, k, n, x.dtype)
    if var == "wgmma" and (x.data_ptr() % 16 or y.data_ptr() % 16):
        raise ValueError("the wgmma matmul takes 16-byte aligned operands")
    lib = _library()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _ENTRY[var, x.dtype])(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"matmul {var} kernel launch failed: {msg} "
                           f"({rc})")
    matmul.launches += 1
    matmul.launches_by_variant[var] += 1
    return out


matmul.launches = 0
matmul.launches_by_variant = dict.fromkeys(("wgmma", "simt"), 0)
