"""Tests of the port that need an NVIDIA GPU (marker `cuda`): they skip
without one.  They import torch and the port only, so they also run on
a machine without jax:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The CPU guard of the same path is in tests/test_torch_train.py; the
kernels' full checks on the card are chip_smoke.py's phases."""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as T_fa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref)
from repro_torch.models import layers as T_L


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_never_returns_a_detached_result(dtype):
    """On the card, q, k, v that need a gradient give an output that
    records the backward kernel."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 4, 70, 64), generator=gen, device="cuda")
               .to(dtype).requires_grad_() for _ in range(3))
    before = T_fa.attend_backward.launches
    out = T_L.flash_attention(q, k, v, causal=True)
    assert out.requires_grad
    out.float().sum().backward()
    assert T_fa.attend_backward.launches == before + 1
    assert all(t.grad is not None for t in (q, k, v))


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_the_plain_backward():
    """float32, GQA, ragged, causal: within 1e-4 of the plain
    gradient's largest magnitude (chip_smoke's float32 bound)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, do = (torch.randn((2, 4, 77, 32), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((2, 2, 77, 32), generator=gen, device="cuda")
            for _ in range(2))
    o, lse = T_fa.attend(q, k, v, causal=True, return_lse=True)
    got = T_fa.attend_backward(q, k, v, o, do, lse, causal=True)
    o_ref, lse_ref = attention_lse_ref(q, k, v, causal=True)
    want = attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=True)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.cuda
def test_cuda_bf16_backward_runs_on_wgmma_and_is_deterministic():
    """bf16, GQA, ragged Sq and Sk, causal after a prefix: on the wgmma
    variant, within 2e-2 of the plain gradient's largest magnitude
    (chip_smoke's bf16 bound), bit-identical from call to call (no
    atomics), and dK = dV = 0 for the keys no query sees."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    off, sq, sk = 200, 77, 333          # keys past 276 are seen by none
    q, do = randn(2, 4, sq, 128), randn(2, 4, sq, 128)
    k, v = randn(2, 2, sk, 128), randn(2, 2, sk, 128)
    o, lse = T_fa.attend(q, k, v, causal=True, q_offset=off,
                         return_lse=True)
    before = dict(T_fa.attend_backward.launches_by_variant)
    got = T_fa.attend_backward(q, k, v, o, do, lse, causal=True,
                               q_offset=off)
    again = T_fa.attend_backward(q, k, v, o, do, lse, causal=True,
                                 q_offset=off)
    torch.cuda.synchronize()
    after = T_fa.attend_backward.launches_by_variant
    assert {var: after[var] - before[var] for var in after} == \
        {"wgmma": 2, "simt": 0}
    want = attention_bwd_ref(q, k, v, o, do, lse, causal=True,
                             q_offset=off)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert (g.float() - w.float()).abs().max() \
            <= 2e-2 * w.float().abs().max()
    unseen = off + sq
    assert not got[1][:, :, unseen:].any() and not got[2][:, :, unseen:].any()
