"""GQA entry point of the flash kernel: the port of
`repro.kernels.flash_attention.ops`."""
from __future__ import annotations

import torch

from .flash_attention import attend, check_blocks, flash_attention
from .ref import attention_ref  # noqa: F401  (public kernel surface)


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, bq: int = 512,
                        bkv: int = 512) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.

    On the card the kernel reads each query head's KV head in place
    (`attend`); the reference repeats the KV heads first, which gives
    the same result.  On the CPU the KV heads are repeated and the
    (BH, S, D) wrapper runs its plain version."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of KV heads "
                         f"{hkv}")
    if q.device.type == "cuda":
        check_blocks(s, k.shape[2], bq, bkv)
        return attend(q, k, v, causal=causal)
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = flash_attention(
        q.reshape(b * hq, s, d), k.reshape(b * hq, s, d),
        v.reshape(b * hq, s, d), causal=causal, bq=bq, bkv=bkv)
    return out.reshape(b, hq, s, d)
