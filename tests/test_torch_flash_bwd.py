"""The flash-attention backward's plain version, the forward's
log-sum-exp and the differentiable entry (`FlashAttention`) against
the reference, on the CPU.

The reference has no Pallas backward: it trains through the jnp flash
loop `repro.models.layers.flash_attention` and differentiates it with
`jax.grad`.  The port's plain backward (`ref.attention_bwd_ref`, the
formula the CUDA kernel computes) is held to that gradient on numpy
inputs from a seed, in float32: dq, dk and dv within 1e-5 (rtol and
atol; largest error measured 2.4e-6), and to autograd through the
port's own plain forward (`ref.attention_ref`) within the same bound.
The log-sum-exp of `ref.attention_lse_ref` equals a float64 one within
1e-5.  The kernels themselves run only on the card (`chip_smoke.py`,
phase `flash_bwd_vs_plain`).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as R_L
from repro_torch.kernels.flash_attention import flash_attention as T_fa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.models import layers as T_L

TOL = dict(rtol=1e-5, atol=1e-5)

# (b, hq, hkv, sq, sk, d, causal, chunk, q_offset): several chunks with
# GQA, one full chunk, a causal query block after a prefix, head dim 128.
CASES = [
    (1, 4, 2, 64, 64, 32, True, 16, 0),
    (2, 2, 2, 48, 48, 64, False, 1024, 0),
    (1, 4, 4, 40, 64, 32, True, 16, 24),
    (1, 2, 1, 33, 33, 128, True, 1024, 0),
]


def _inputs(case, seed=0):
    b, hq, hkv, sq, sk, d, _, _, _ = case
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return draw(b, hq, sq, d), draw(b, hkv, sk, d), draw(b, hkv, sk, d), \
        draw(b, hq, sq, d)


def _reference_grads(case, q, k, v, do):
    *_, causal, chunk, off = case

    def f(q, k, v):
        out = R_L.flash_attention(q, k, v, causal=causal, chunk=chunk,
                                  q_offset=off)
        return jnp.sum(out * do)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_jax_grad_of_the_reference(case):
    q, k, v, do = _inputs(case)
    causal, off = case[6], case[8]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_lse_ref(tq, tk, tv, causal=causal, q_offset=off)
    got = attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                            q_offset=off)
    for g, r in zip(got, _reference_grads(case, q, k, v, do)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_layers_flash_attention_gradient_matches_the_reference(case):
    """The LM's attention with inputs that need a gradient: forward
    equal to the reference's, gradients equal to `jax.grad`'s."""
    q, k, v, do = _inputs(case, seed=1)
    *_, causal, chunk, off = case
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = T_L.flash_attention(*leaves, causal=causal, chunk=chunk,
                              q_offset=off)
    ref_out = R_L.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  chunk=chunk, q_offset=off)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    out.backward(torch.from_numpy(do))
    for t, r in zip(leaves, _reference_grads(case, q, k, v, do)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    q, k, v, do = _inputs(case, seed=2)
    b, hq, hkv, sq, sk, d, causal, _, off = case
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    g = hq // hkv
    out = attention_ref(
        leaves[0].reshape(b * hq, sq, d),
        leaves[1].repeat_interleave(g, 1).reshape(b * hq, sk, d),
        leaves[2].repeat_interleave(g, 1).reshape(b * hq, sk, d),
        causal=causal, q_offset=off).reshape(b, hq, sq, d)
    out.backward(tdo)
    o, lse = attention_lse_ref(tq, tk, tv, causal=causal, q_offset=off)
    torch.testing.assert_close(o, out.detach(), **TOL)
    got = attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal=causal,
                            q_offset=off)
    for g_, leaf in zip(got, leaves):
        torch.testing.assert_close(g_, leaf.grad, **TOL)


def test_lse_is_the_rows_log_sum_exp():
    case = CASES[2]
    q, k, v, _ = _inputs(case, seed=3)
    _, hq, hkv, sq, sk, d, causal, _, off = case
    _, lse = attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, q_offset=off)
    kk = np.repeat(k.astype(np.float64), hq // hkv, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) \
        / math.sqrt(d)
    mask = (np.arange(sq)[:, None] + off) >= np.arange(sk)[None, :]
    s = np.where(mask, s, -np.inf)
    mx = s.max(axis=-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_the_function_counts_its_calls_and_uses_the_plain_versions_on_cpu():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES[0], seed=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (T_fa.attention.calls, T_fa.attend_backward.launches,
              T_fa.flash_attention.launches)
    out = T_fa.attention(*leaves, causal=True)
    out.backward(do)
    # One call of the entry; no kernel launch on the CPU.
    assert (T_fa.attention.calls, T_fa.attend_backward.launches,
            T_fa.flash_attention.launches) == \
        (before[0] + 1, before[1], before[2])
    o, lse = attention_lse_ref(q, k, v, causal=True)
    want = attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0.0, atol=0.0)


def test_the_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="cuda"):
        T_fa.attend(q, k, v, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="cuda"):
        T_fa.attend_backward(q, k, v, q, do, lse, causal=True)


def test_backward_entries_are_c_functions_of_the_source():
    """The wrapper's ctypes entry names are the source's C functions
    (the library itself is built only on the card)."""
    import re

    from repro_torch.kernels import build

    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    entries = set(re.findall(r'extern "C" (?:int|const char\*)\s+(\w+)\(',
                             text))
    assert set(T_fa._BWD_ENTRY.values()) | {"repro_flash_bwd_error_string"} \
        == entries
    assert set(T_fa._BWD_ENTRY) == set(T_fa._VARIANT)
