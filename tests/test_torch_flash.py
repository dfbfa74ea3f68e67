"""The port's flash attention against the reference, on the CPU.

- The kernel wrapper `flash_attention` and `gqa_flash_attention` (their
  CPU path is the plain version, `attention_ref`) against the
  reference's Pallas kernel in interpret mode and its `attention_ref`,
  on tests/test_kernels.py's sweep: 2e-5 for float32, 2e-2 for bfloat16
  (the reference's own tolerances).
- The LM's `layers.flash_attention` (CPU path: the chunked streaming
  softmax) against the reference's `layers.flash_attention`: GQA,
  chunk < S, q_offset > 0, non-causal with Sq != Sk.
- The wrappers' checks.
- The custom ops `repro_torch::flash_fwd` and `repro_torch::flash_bwd`:
  on the CPU bit-equal to the plain versions they replaced in the
  wrappers (`attention_lse_ref`, `attention_bwd_ref`); on the meta
  device the outputs' shapes and types, forward and backward; their
  FLOP formula (4 B Hq D per unmasked pair forward, 2.5 times that
  backward) against a count of the pairs, and counted as such by
  `FlopCounterMode` on the CPU and on the meta device.

The CUDA kernel runs only on the card: `chip_smoke.py` holds it against
`attention_ref` there.  Inputs are drawn with numpy and handed to both
packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as R_ops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as R_flash
from repro.kernels.flash_attention.ref import attention_ref as R_ref
from repro.models import layers as R_layers
from repro_torch.kernels.flash_attention import flash_attention as T_mod
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.models import layers as T_layers

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py:37-39: (sq, sk) x causal, causal only square.
SWEEP = [(sq, sk, causal) for (sq, sk) in [(128, 128), (256, 128),
                                           (128, 256)]
         for causal in (True, False) if not causal or sq == sk]


def _inputs(shapes, dtype, seed):
    """The same random arrays as (jax, torch) pairs in `dtype`."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sq,sk,causal", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wrapper_matches_reference(sq, sk, causal, dtype):
    bh, d = 3, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(bh, sq, d), (bh, sk, d), (bh, sk, d)], dtype, sq + sk)
    out = T_mod.flash_attention(tq, tk, tv, causal=causal, bq=64, bkv=64)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = TOL[dtype]
    _close(out, R_flash(jq, jk, jv, causal=causal, bq=64, bkv=64,
                        interpret=True), tol)
    _close(out, R_ref(jq, jk, jv, causal=causal), tol)
    _close(attention_ref(tq, tk, tv, causal=causal),
           R_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (4, 4, 64), (8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_flash_matches_reference(hq, hkv, d, dtype):
    b, s = 2, 128
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype, hq * d)
    out = gqa_flash_attention(tq, tk, tv, causal=True, bq=64, bkv=64)
    ref = R_ops.gqa_flash_attention(jq, jk, jv, causal=True, bq=64, bkv=64,
                                    interpret=True)
    _close(out, ref, TOL[dtype])


# (b, hq, hkv, sq, sk, d, causal, chunk, q_offset)
LAYER_CASES = {
    "gqa_one_chunk": (2, 4, 2, 64, 64, 32, True, 1024, 0),
    "gqa_chunked": (1, 4, 2, 128, 128, 32, True, 32, 0),
    "q_offset": (2, 4, 1, 16, 96, 64, True, 32, 80),
    "noncausal_sq_ne_sk": (1, 2, 2, 40, 96, 64, False, 48, 0),
    "odd_chunk_d128": (1, 4, 2, 100, 100, 128, True, 50, 0),
}


@pytest.mark.parametrize("case", LAYER_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_flash_attention_matches_reference(case, dtype):
    b, hq, hkv, sq, sk, d, causal, chunk, q_offset = LAYER_CASES[case]
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)], dtype,
        sq * 7 + sk)
    out = T_layers.flash_attention(tq, tk, tv, causal=causal, chunk=chunk,
                                   q_offset=q_offset)
    ref = R_layers.flash_attention(jq, jk, jv, causal=causal, chunk=chunk,
                                   q_offset=q_offset)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    _close(out, ref, TOL[dtype])


def test_attention_ref_q_offset_is_a_row_shift():
    """`q_offset` (the port's addition to the plain version) masks as
    the reference's `layers.flash_attention` does."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(1, 2, 8, 32), (1, 2, 24, 32), (1, 2, 24, 32)], "float32", 5)
    out = attention_ref(tq[0], tk[0], tv[0], causal=True, q_offset=16)
    ref = R_layers.flash_attention(jq, jk, jv, causal=True, chunk=8,
                                   q_offset=16)
    _close(out, ref[0], TOL["float32"])


def test_wrappers_check_like_the_reference():
    x = torch.zeros((2, 96, 32))
    with pytest.raises(ValueError, match="must divide"):
        T_mod.flash_attention(x, x, x, bq=64, bkv=64)
    with pytest.raises(TypeError):
        T_mod.flash_attention(x, x.to(torch.bfloat16), x)
    y = torch.zeros((1, 2, 100, 32))
    with pytest.raises(ValueError, match="chunks do not divide"):
        T_layers.flash_attention(y, y, y, causal=True, chunk=30)
    with pytest.raises(ValueError, match="runs on cuda"):
        T_mod.attend(x[None], x[None], x[None], causal=True)


def test_cpu_path_launches_no_kernel():
    before = T_mod.flash_attention.launches
    by_variant = dict(T_mod.flash_attention.launches_by_variant)
    x = torch.zeros((1, 64, 32))
    T_mod.flash_attention(x, x, x)
    T_mod.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16())
    T_layers.flash_attention(x[None], x[None], x[None], causal=True)
    assert T_mod.flash_attention.launches == before
    assert T_mod.flash_attention.launches_by_variant == by_variant


# (b, hq, hkv, sq, sk, d, causal, q_offset)
OP_CASES = [(2, 4, 2, 64, 64, 32, True, 0), (1, 4, 1, 16, 96, 64, True, 80),
            (1, 2, 2, 40, 96, 64, False, 0), (2, 4, 2, 48, 48, 80, True, 5)]


@pytest.mark.parametrize("case", OP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ops_on_the_cpu_are_the_plain_versions(case, dtype):
    b, hq, hkv, sq, sk, d, causal, off = case
    rng = np.random.default_rng(sq + sk + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((b, hq, sq, d), (b, hkv, sk, d),
                                         (b, hkv, sk, d), (b, hq, sq, d)))
    o, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, off, True)
    want_o, want_lse = attention_lse_ref(q, k, v, causal=causal, q_offset=off)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    o2, empty = torch.ops.repro_torch.flash_fwd(q, k, v, causal, off, False)
    assert torch.equal(o2, want_o) and empty.numel() == 0
    grads = torch.ops.repro_torch.flash_bwd(q, k, v, o, do, lse, causal, off)
    for got, want in zip(grads, attention_bwd_ref(q, k, v, o, do, lse,
                                                  causal=causal,
                                                  q_offset=off)):
        assert torch.equal(got, want)
    layer = T_layers.flash_attention(q, k, v, causal=causal, chunk=sk,
                                     q_offset=off)
    assert torch.equal(layer, want_o)


def test_flash_ops_on_meta_give_shapes_only():
    before = (T_mod.flash_attention.launches,
              T_mod.attend_backward.launches)
    q = torch.empty((2, 8, 64, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 4, 96, 128), dtype=torch.bfloat16, device="meta")
    out = T_mod.attend(q, kv, kv, causal=True)
    assert (out.device.type, out.shape, out.dtype) == \
        ("meta", q.shape, q.dtype)
    out, lse = T_mod.attend(q, kv, kv, causal=True, q_offset=32,
                            return_lse=True)
    assert lse.shape == (2, 8, 64) and lse.dtype == torch.float32
    dq, dk, dv = T_mod.attend_backward(q, kv, kv, out, out, lse,
                                       causal=True, q_offset=32)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, kv.shape, kv.shape)
    qg, kg = (t.clone().requires_grad_() for t in (q, kv))
    y = T_layers.flash_attention(qg, kg, kg, causal=True)
    y.float().sum().backward()
    assert qg.grad.shape == q.shape and kg.grad.device.type == "meta"
    with pytest.raises(ValueError, match="head dims"):
        T_mod.attend(q[..., :96], kv[..., :96], kv[..., :96], causal=True)
    assert before == (T_mod.flash_attention.launches,
                      T_mod.attend_backward.launches)


@pytest.mark.parametrize("sq,sk", [(1, 1), (7, 7), (5, 9), (9, 5), (64, 32),
                                   (1, 4096)])
@pytest.mark.parametrize("q_offset", [0, 1, 3, 8, 40])
def test_causal_pairs_counts_the_unmasked_pairs(sq, sk, q_offset):
    rows = np.arange(sq)[:, None] + q_offset
    mask = rows >= np.arange(sk)[None, :]
    assert T_mod.causal_pairs(sq, sk, True, q_offset) == int(mask.sum())
    assert T_mod.causal_pairs(sq, sk, False, q_offset) == sq * sk


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_flop_counter_counts_the_flash_ops_by_formula(device):
    """The formula of PERF.md's kernel table: q (4, 16, 4096, 128)
    causal is 2.75e11 FLOPs forward; here a small case, counted by
    FlopCounterMode through the differentiable entry on either
    device."""
    from torch.utils.flop_counter import FlopCounterMode

    assert T_mod.flash_fwd_flops((4, 16, 4096, 128), (4, 8, 4096, 128),
                                 True, 0) == 4 * 4 * 16 * 128 * 4096 * 4097 \
        // 2
    b, hq, hkv, s, d = 2, 4, 2, 24, 32
    q = torch.randn((b, hq, s, d), device=device, requires_grad=True)
    k = torch.randn((b, hkv, s, d), device=device, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        y = T_mod.attention(q, k, k, causal=True, q_offset=2)
        y.sum().backward()
    counts = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    fwd = 4 * b * hq * d * T_mod.causal_pairs(s, s, True, 2)
    assert counts == {"repro_torch.flash_fwd": fwd,
                      "repro_torch.flash_bwd": 5 * fwd // 2}
