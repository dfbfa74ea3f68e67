"""Flash attention: the Hopper CUDA kernels, forward
(``kernels/csrc/flash_attention.cu``) behind the reference's signature
and backward (``kernels/csrc/flash_attention_bwd.cu``), and the
`torch.autograd.Function` that joins them for training.

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

`attend(..., return_lse=True)` also returns each query row's
log-sum-exp (float32, (B, Hq, Sq)), which `attend_backward` takes to
compute dq, dk and dv without the (Sq, Sk) probabilities, on the
variant `variant(dtype)` names: every bfloat16 call on "wgmma" (tensor
cores and TMA, P and dS rounded to bfloat16 before the products that
take them, float32 accumulation), every float32 call on "simt" (IEEE
float32 FMA).  `attention` is the differentiable entry:
`FlashAttention.apply`, whose forward is `attend` with the LSE and
whose backward is `attend_backward`.

A CPU tensor goes through the plain versions (`ref.attention_ref`,
`ref.attention_lse_ref`, `ref.attention_bwd_ref`); a CUDA tensor always
launches its variant's kernel or raises.  `flash_attention.launches`
counts the forward kernel's launches, and
`flash_attention.launches_by_variant` counts them per variant;
`attend_backward.launches` counts the backward kernel's (one a call, of
its three passes), and `attend_backward.launches_by_variant` per
variant; `attention.calls` counts calls of the differentiable entry on
either device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

HEAD_DIMS = (32, 64, 128)
_ENTRY = {"simt": "repro_flash_attention_f32",
          "wgmma": "repro_flash_attention_bf16_wgmma"}
_VARIANT = {torch.float32: "simt", torch.bfloat16: "wgmma"}
_BWD_ENTRY = {torch.float32: "repro_flash_attention_bwd_f32",
              torch.bfloat16: "repro_flash_attention_bwd_bf16"}


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_flash_error_string.argtypes = [ctypes.c_int]
    lib.repro_flash_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """The built backward library with its C signatures declared."""
    from ..build import load

    lib = load("flash_attention_bwd")
    for entry in _BWD_ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.repro_flash_bwd_error_string.restype = ctypes.c_char_p
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


def _check_kernel_operands(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_offset: int) -> None:
    """What the CUDA kernels need beyond `_check_operands`."""
    _check_operands(q, k, v, 4)
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on cuda, not {q.device}")
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[3]
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


def _check_aligned(var: str, **tensors: torch.Tensor) -> None:
    """The wgmma kernels load through TMA, which takes 16-byte aligned
    tensors."""
    if var == "wgmma":
        off = [name for name, t in tensors.items() if t.data_ptr() % 16]
        if off:
            raise ValueError(f"the wgmma flash kernels take 16-byte "
                             f"aligned {', '.join(tensors)}; not {off}")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_offset: int = 0, return_lse: bool = False):
    """Launch the kernel: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D),
    contiguous CUDA tensors of one type, Hq % Hkv == 0.  Query row i
    sits at position `q_offset + i`; with `causal` it sees keys
    j <= q_offset + i.  Returns (B, Hq, Sq, D) in q's type, and with
    `return_lse` also each row's log-sum-exp of its scaled scores,
    (B, Hq, Sq) float32.  The output carries no gradient: training goes
    through `attention`."""
    _check_kernel_operands(q, k, v, q_offset)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    var = variant(q.dtype)
    _check_aligned(var, q=q, k=k, v=v)
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _ENTRY[var])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, hq, hkv, sq, sk, d, int(causal), q_offset,
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.repro_flash_error_string(rc).decode()
        raise RuntimeError(f"flash attention {var} kernel launch failed: "
                           f"{msg} ({rc})")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[var] += 1
    return (out, lse) if return_lse else out


def attend_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                    causal: bool, q_offset: int = 0):
    """Launch the backward kernel: the gradients (dq, dk, dv) of
    `attend`'s output `o` for the output gradient `do` (both shaped and
    typed like q), from the forward's `lse` ((B, Hq, Sq) float32).  All
    contiguous CUDA tensors, and 16-byte aligned for the wgmma variant.
    dk and dv are summed over each KV head's query group; each gradient
    comes back in its input's type."""
    _check_kernel_operands(q, k, v, q_offset)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} "
                             f"tensor shaped like q {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, hq, sq)} "
                         f"on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    var = variant(q.dtype)
    _check_aligned(var, q=q, k=k, v=v, o=o, do=do)
    lib = _bwd_library()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _BWD_ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, d,
            int(causal), q_offset, 1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.repro_flash_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash attention backward {var} kernel "
                           f"launch failed: {msg} ({rc})")
    attend_backward.launches += 1
    attend_backward.launches_by_variant[var] += 1
    return dq, dk, dv


attend_backward.launches = 0
attend_backward.launches_by_variant = dict.fromkeys(_ENTRY, 0)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention at `attend`'s interface.  On the
    card the forward launches the forward kernel with its LSE output and
    the backward launches the backward kernel; on the CPU both are the
    plain versions.  Nothing else: no library attention, no fallback."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        if q.device.type == "cpu":
            out, lse = attention_lse_ref(q, k, v, causal=causal,
                                         q_offset=q_offset)
        else:
            out, lse = attend(q, k, v, causal=causal, q_offset=q_offset,
                              return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        fn = attention_bwd_ref if q.device.type == "cpu" else attend_backward
        dq, dk, dv = fn(q, k, v, out, dout, lse, causal=ctx.causal,
                        q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Differentiable attention at `attend`'s interface (q (B, Hq, Sq,
    D), k and v (B, Hkv, Sk, D)): `FlashAttention.apply`."""
    _check_operands(q, k, v, 4)
    attention.calls += 1
    return FlashAttention.apply(q, k, v, causal, q_offset)


attention.calls = 0


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
