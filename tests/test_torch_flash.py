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
from repro_torch.kernels.flash_attention.ref import attention_ref
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
