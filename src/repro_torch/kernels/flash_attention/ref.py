"""Plain PyTorch version of the flash-attention kernel: the
materialized softmax (the port of `repro.kernels.flash_attention.ref`).
The wrapper uses it for CPU tensors; the chip smoke test holds the CUDA
kernel against it on the card."""
import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, *, q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH, Sk, D).  Scores and probabilities in
    float32, the result in q's type.  `q_offset` is the position of
    q[:, 0] for the causal mask (0 in the reference, which has no such
    argument): row i sees keys j <= q_offset + i."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = rows >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None], s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
