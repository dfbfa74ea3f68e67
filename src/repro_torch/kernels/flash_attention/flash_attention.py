"""Flash attention (forward): the Hopper CUDA kernel
(``kernels/csrc/flash_attention.cu``) behind the reference's signature.

The port of `repro.kernels.flash_attention.flash_attention` (the Pallas
TPU kernel `_flash_kernel`).  `flash_attention(q, k, v, causal=, bq=,
bkv=)` keeps the reference's (BH, S, D) layout and its checks — blocks
are clipped to the problem with `min` and must divide it — but the CUDA
kernels tile with their own Hopper tiles: the TPU's (bq, bkv) are VMEM
tiles, and they do not steer the CUDA tiling.

Two kernels, chosen by `variant(dtype)` from the type alone: every
bfloat16 call runs on "wgmma" (tensor cores and TMA, 128 query rows per
block, keys in tiles of 128, P rounded to bfloat16 before P @ V), every
float32 call on "simt" (IEEE float32 FMA, 64 query rows per block, keys
in tiles of 64).

`attend` is the kernel's full interface, which the GQA wrapper and the
LM's attention call: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) with
grouped-query heads read in place, a causal mask offset by `q_offset`,
and any Sq, Sk (ragged tails are masked inside the kernel).  The kernel
supports head dims 32, 64 and 128.

A CPU tensor goes through the plain version (`ref.attention_ref`); a
CUDA tensor always launches its variant's kernel or raises.
`flash_attention.launches` counts the kernel launches, and
`flash_attention.launches_by_variant` counts them per variant.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .ref import attention_ref

HEAD_DIMS = (32, 64, 128)
_ENTRY = {"simt": "repro_flash_attention_f32",
          "wgmma": "repro_flash_attention_bf16_wgmma"}
_VARIANT = {torch.float32: "simt", torch.bfloat16: "wgmma"}


def variant(dtype: torch.dtype) -> str:
    """The kernel a call in `dtype` runs on: "wgmma" for bfloat16,
    "simt" for float32."""
    return _VARIANT[dtype]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from ..build import load

    lib = load("flash_attention")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_flash_error_string.argtypes = [ctypes.c_int]
    lib.repro_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ndim: int) -> None:
    """Ranks, shapes, types and devices the kernel and its plain
    version both need."""
    if q.dim() != ndim or k.dim() != ndim or v.dim() != ndim:
        raise ValueError(f"flash attention takes {ndim}-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "differ")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch or head dim")
    if min(q.shape[-2], k.shape[-2]) < 1:
        raise ValueError("empty query or key sequence")
    if q.dtype not in _VARIANT or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 "
                        f"operands of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D),
    contiguous CUDA tensors of one type, Hq % Hkv == 0.  Query row i
    sits at position `q_offset + i`; with `causal` it sees keys
    j <= q_offset + i.  Returns (B, Hq, Sq, D) in q's type."""
    _check_operands(q, k, v, 4)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on cuda, not {q.device}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of KV heads "
                         f"{hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash kernel takes contiguous q, k, v")
    var = variant(q.dtype)
    if var == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the wgmma flash kernel takes 16-byte aligned "
                         "q, k, v")
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _ENTRY[var])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, sk, d, int(causal), q_offset,
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.repro_flash_error_string(rc).decode()
        raise RuntimeError(f"flash attention {var} kernel launch failed: "
                           f"{msg} ({rc})")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[var] += 1
    return out


def check_blocks(sq: int, sk: int, bq: int, bkv: int) -> None:
    """The reference's block check: (bq, bkv), clipped to (Sq, Sk),
    must divide them."""
    bq, bkv = min(bq, sq), min(bkv, sk)
    if sq % bq or sk % bkv:
        raise ValueError(f"blocks (bq={bq}, bkv={bkv}) must divide the "
                         f"sequences (sq={sq}, sk={sk})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bkv: int = 512) -> torch.Tensor:
    """q, k, v: (BH, S, D) — batch*heads flattened, same KV length as
    in the reference (GQA callers repeat KV heads, or call `attend`).
    Blocks must divide the sequences after clipping, as in the
    reference."""
    _check_operands(q, k, v, 3)
    check_blocks(q.shape[1], k.shape[1], bq, bkv)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return attend(q[None], k[None], v[None], causal=causal)[0]


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(_ENTRY, 0)
