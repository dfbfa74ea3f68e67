"""Plain PyTorch versions of the flash-attention kernels: the
materialized softmax (the port of `repro.kernels.flash_attention.ref`),
the same at the kernels' (B, H, S, D) grouped-query interface with the
per-row log-sum-exp the forward kernel writes, and the backward that
the backward kernel computes from it.  The wrappers use them for CPU
tensors; the chip smoke test holds the CUDA kernels against them on
the card."""
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            q_offset: int) -> torch.Tensor:
    """Scaled float32 scores (B, Hkv, G, Sq, Sk) of q (B, Hq, Sq, D)
    against k (B, Hkv, Sk, D), G = Hq // Hkv query heads per KV head;
    keys a row may not see are -inf."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(d)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = rows >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, -torch.inf)
    return s


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D).  Returns (out (B, Hq, Sq,
    D) in q's type, lse (B, Hq, Sq) float32): the attention and each
    query row's log-sum-exp of its scaled scores."""
    b, hq, sq = q.shape[:3]
    s = _scores(q, k, causal, q_offset)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(q.shape).to(q.dtype), lse.reshape(b, hq, sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool, q_offset: int = 0):
    """The gradients (dq, dk, dv) of `attention_lse_ref`'s output for
    the output gradient `do`, from the forward's output `o` and `lse`:
    P = exp(S * scale - LSE), dV = P^T dO, dS = P (dO V^T - Delta) with
    Delta = rowsum(dO * O), dQ = dS K * scale, dK = dS^T Q * scale;
    dK and dV summed over each KV head's query group.  In float32, each
    gradient returned in its input's type."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    p = torch.exp(_scores(q, k, causal, q_offset)
                  - lse.reshape(b, hkv, g, sq)[..., None])
    dog = do.float().reshape(b, hkv, g, sq, d)
    delta = (dog * o.float().reshape(b, hkv, g, sq, d)).sum(dim=-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
              - delta[..., None])
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(b, hkv, g, sq, d)) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
