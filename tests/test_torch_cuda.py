"""Tests of the port that need an NVIDIA GPU (marker `cuda`): they skip
without one.  They import torch and the port only, so they also run on
a machine without jax:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The CPU guard of the same path is in tests/test_torch_train.py; the
kernels' full checks on the card are chip_smoke.py's phases."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels.flash_attention import flash_attention as T_fa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref)
from repro_torch.models import layers as T_L
from repro_torch.models.lm import build_model
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_dims_outside_the_kernels_raise(dtype):
    """No fallback: the forward and the backward take the configs' head
    dims, each on its type's variant, and raise on another."""
    _card()

    def qkv(d):
        return [torch.randn((1, 2, 64, d), device="cuda").to(dtype)
                for _ in range(3)]

    for d in T_fa.HEAD_DIMS:
        q, k, v = qkv(d)
        out, lse = T_fa.attend(q, k, v, causal=True, return_lse=True)
        assert out.shape == (1, 2, 64, d)
        before = dict(T_fa.attend_backward.launches_by_variant)
        grads = T_fa.attend_backward(q, k, v, out, out, lse, causal=True)
        after = T_fa.attend_backward.launches_by_variant
        assert {var: after[var] - before[var] for var in after} == \
            {var: int(var == T_fa.variant(dtype)) for var in after}
        assert all(g.shape == t.shape and bool(torch.isfinite(g).all())
                   for g, t in zip(grads, (q, k, v)))
    q, k, v = qkv(96)
    with pytest.raises(ValueError, match="head dims"):
        T_fa.attend(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head dims"):
        T_fa.attend_backward(q, k, v, q, q, q[..., 0].float(), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "mamba2_1_3b",
                                  "jamba_v0_1_52b"])
def test_cuda_bf16_training_step_of_the_moe_and_ssm_families(arch):
    """One training step of the reduced MoE, SSM and hybrid configs in
    bf16 compute on the card (`make_train_step`: the MoE dispatch and
    the SSD scan under autograd): a finite loss, every parameter
    finite, and one backward kernel launch on wgmma per attention layer
    (none for the SSM)."""
    _card()
    cfg = get_config(arch, reduced=True)
    assert cfg.compute_dtype == "bfloat16"
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
    step, _ = make_train_step(model, tcfg)
    params, opt = init_train_state(model, tcfg)
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=128,
                      global_batch=2)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_batch(data, 0).items()}
    before = dict(T_fa.attend_backward.launches_by_variant)
    params, opt, met = step(params, opt, batch)
    torch.cuda.synchronize()
    after = T_fa.attend_backward.launches_by_variant
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    assert {var: after[var] - before[var] for var in after} == \
        {"wgmma": n_attn, "simt": 0}
    assert bool(torch.isfinite(met["loss"]))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
