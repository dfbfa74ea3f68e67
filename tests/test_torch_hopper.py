"""The port's Hopper tensor-core paths, on the CPU.

The wgmma kernels run only on the card (`chip_smoke.py` holds them
against their plain versions there).  What the CPU can check:

- which kernel a call runs on: the matmul's `variant(m, k, n, dtype)`
  on chip_smoke's shapes and the Qwen3-0.6B FFN shape, and the flash
  dispatch by type; every entry the wrappers call is a C function of
  the kernel sources;
- the numerics contract of the bf16 flash kernel: an emulation of its
  arithmetic (float32 scores from bf16 q and k, the online softmax over
  128-key tiles, P rounded to bf16 before P @ V, float32 accumulation,
  the output rounded to bf16) against the reference's Pallas kernel in
  interpret mode, within the bf16 tolerance chip_smoke enforces (2e-2);
- the numerics contract of the bf16 flash backward: an emulation of
  its arithmetic (float32 dots of bf16 inputs, P and dS rounded to bf16
  before the dV, dK and dQ products, float32 accumulation over the
  kernel's 64-row tiles, gradients rounded to bf16) against `jax.grad`
  of the reference's jnp flash loop, within the same 2e-2 of the
  largest gradient; and which backward kernel each type reaches;
- that the build hashes the shared header, so a changed `hopper.cuh`
  rebuilds every library that includes it.

Inputs are drawn with numpy and handed to both packages."""
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as R_ops
from repro.models import layers as R_L
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention as T_flash
from repro_torch.kernels.flash_attention.ref import attention_lse_ref
from repro_torch.kernels.matmul import matmul as T_matmul

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 2e-2
FFN_SHAPE = (4096, 1024, 3072)   # (m, k, n): Qwen3-0.6B up-projection


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


@pytest.mark.parametrize("shape", CHIP_SMOKE.MM_SHAPES + [FFN_SHAPE],
                         ids=str)
def test_matmul_variant_by_shape_and_type(shape):
    m, k, n = shape
    expected = "simt" if shape == CHIP_SMOKE.MM_SIMT_BF16 else "wgmma"
    assert T_matmul.variant(m, k, n, torch.bfloat16) == expected
    assert T_matmul.variant(m, k, n, torch.float32) == "simt"


@pytest.mark.parametrize("m,k,n,expected", [
    (1, 8, 8, "wgmma"), (7, 72, 264, "wgmma"), (64, 12, 64, "simt"),
    (64, 64, 12, "simt"), (64, 8, 4, "simt")])
def test_matmul_variant_needs_16_byte_rows(m, k, n, expected):
    assert T_matmul.variant(m, k, n, torch.bfloat16) == expected


def test_flash_variant_by_type():
    assert T_flash.variant(torch.bfloat16) == "wgmma"
    assert T_flash.variant(torch.float32) == "simt"
    cases = CHIP_SMOKE.FLASH_CASES
    assert (1, 16, 8, 130, 4133, 128, True, 4003) in cases
    assert {c[5] for c in cases} == set(T_flash.HEAD_DIMS)


def _c_entries(source: str) -> set[str]:
    text = (build.CSRC / source).read_text()
    return set(re.findall(r'extern "C" (?:int|const char\*)\s+(\w+)\(',
                          text))


def test_wrapper_entries_are_c_functions_of_the_sources():
    mm, fa = _c_entries("matmul.cu"), _c_entries("flash_attention.cu")
    assert set(T_matmul._ENTRY.values()) | {"repro_cuda_error_string"} \
        == mm
    assert set(T_flash._ENTRY.values()) | {"repro_flash_error_string"} \
        == fa
    assert set(T_matmul.matmul.launches_by_variant) == {"wgmma", "simt"}
    assert set(T_flash.flash_attention.launches_by_variant) == \
        {"wgmma", "simt"}


def tc_flash_emulation(q, k, v, *, causal, bkv=128, round_p=True):
    """The bf16 wgmma kernel's arithmetic in plain PyTorch: q (B, Hq, S,
    D), k and v (B, Hkv, S, D) in bf16.  Scores are float32 dots of the
    bf16 inputs; the online softmax runs over `bkv`-key tiles in log2
    units with the scale folded in; P is rounded to bf16 (unless
    `round_p` is False) before P @ V, which accumulates in float32; the
    output is rounded to bf16."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(group, 1).float()
    vf = v.repeat_interleave(group, 1).float()
    sk = kf.shape[2]
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    m = torch.full((b, hq, sq), -1e30)
    l_sum = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bkv):
        s = qf @ kf[:, :, k0:k0 + bkv].transpose(-1, -2)
        if causal:
            keys = torch.arange(k0, min(k0 + bkv, sk))[None, :]
            s = torch.where(keys <= rows, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        if round_p:
            p = p.bfloat16().float()
        acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + bkv]
        m = m_new
    return (acc / l_sum.clamp_min(1e-30)[..., None]).bfloat16()


def tc_keys_per_tile(d: int) -> int:
    """The wgmma kernel's K/V tile by head dim (`Tile<D>::BKV` in
    flash_attention.cu): 128 keys up to D = 128, 64 above."""
    return 64 if d > 128 else 128


@pytest.mark.parametrize("d", [32, 80, 112, 128, 192, 256])
def test_bf16_flash_numerics_within_reference_tolerance(d):
    """Rounding P to bf16 before P @ V keeps the port within the bf16
    tolerance: GQA 4 over 2, causal, S 256 (two 128-key tiles, or four
    64-key tiles above D = 128), at every head dim of the model configs
    (the kernel holds D = 80 and 112 as 128 columns, zero past D, which
    adds nothing to the scores)."""
    b, hq, hkv, s = 1, 4, 2, 256
    rng = np.random.default_rng(d)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)]]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in arrs)
    ref = np.asarray(R_ops.gqa_flash_attention(
        jq, jk, jv, causal=True, bq=128, bkv=128, interpret=True),
        np.float32)
    got = tc_flash_emulation(tq, tk, tv, causal=True,
                             bkv=tc_keys_per_tile(d))
    err = float(np.abs(got.float().numpy() - ref).max())
    print(f"bf16 tensor-core flash emulation, d={d}: max |err| {err:.3g} "
          f"against the Pallas reference (tolerance {BF16_TOL})")
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL)
    # Rounding P is a real departure from float32 P, not a no-op.
    exact_p = tc_flash_emulation(tq, tk, tv, causal=True,
                                 bkv=tc_keys_per_tile(d), round_p=False)
    assert not torch.equal(got, exact_p)


def tc_flash_bwd_emulation(q, k, v, o, do, lse, *, causal, q_offset=0,
                           tile=64, round_p=True, round_ds=True):
    """The bf16 wgmma backward's arithmetic in plain PyTorch: q, o, do
    (B, Hq, S, D), k, v (B, Hkv, Sk, D) in bf16, lse (B, Hq, S) float32
    in natural units.  Scores and dP are float32 dots of the bf16
    inputs; P = exp2(S * scale * log2 e - LSE * log2 e), masked keys
    exactly 0; dS = P (dP - Delta) with Delta = rowsum(dO * O) in
    float32.  P (unless `round_p` is False) and dS (unless `round_ds` is
    False) are rounded to bf16 before the products that take them;
    dV and dK accumulate in float32 over the query group's heads and
    their `tile`-query tiles in the kernel's order, dQ over `tile`-key
    tiles; the gradients are rounded to bf16 (dQ and dK after the
    scale)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    log2e = math.log2(math.e)
    qf, dof = q.float(), do.float()
    kf = k.repeat_interleave(group, 1).float()
    vf = v.repeat_interleave(group, 1).float()
    delta = (dof * o.float()).sum(-1)
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    if causal:
        rows = torch.arange(sq)[:, None] + q_offset
        p = torch.where(torch.arange(sk)[None, :] <= rows, p, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    if round_p:
        p = p.bfloat16().float()
    if round_ds:
        ds = ds.bfloat16().float()
    dk = torch.zeros((b, hkv, sk, d))
    dv = torch.zeros((b, hkv, sk, d))
    for g in range(group):
        heads = slice(g, hq, group)   # query head h * group + g of KV head h
        for q0 in range(0, sq, tile):
            rows = slice(q0, q0 + tile)
            dv += p[:, heads, rows].transpose(-1, -2) @ dof[:, heads, rows]
            dk += ds[:, heads, rows].transpose(-1, -2) @ qf[:, heads, rows]
    dq = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, tile):
        keys = slice(k0, k0 + tile)
        dq += ds[..., keys] @ kf[:, :, keys]
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


def _reference_flash_grads(q, k, v, do, *, causal, chunk):
    """`jax.grad` of the reference's jnp flash loop
    (`repro.models.layers.flash_attention`) in float32."""
    def loss(q, k, v):
        out = R_L.flash_attention(q, k, v, causal=causal, chunk=chunk)
        return jnp.sum(out * do)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("d", T_flash.HEAD_DIMS)
def test_bf16_flash_backward_numerics_within_reference_tolerance(d):
    """Rounding P and dS to bf16 before the products keeps the wgmma
    backward within the bf16 tolerance of `jax.grad` of the reference's
    jnp flash loop: GQA 4 over 2, causal, S 256 (four 64-row tiles), at
    every head dim the kernel takes (80 and 112 held as 128 columns, zero
    past D; above 128 the two warpgroups split the columns, which leaves
    each product's sums as they are).  The reference runs in float32 on
    the bf16-rounded inputs."""
    b, hq, hkv, s = 1, 4, 2, 256
    rng = np.random.default_rng(100 + d)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d)]]
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrs)
    o = tc_flash_emulation(tq, tk, tv, causal=True)
    _, lse = attention_lse_ref(tq.float(), tk.float(), tv.float(),
                               causal=True)
    got = tc_flash_bwd_emulation(tq, tk, tv, o, tdo, lse, causal=True)
    # The gradient of sum(out * do) at the bf16 kernel's own output o:
    # Delta uses o, as the kernel does; the reference's output differs
    # from o by the forward's rounding only.
    refs = _reference_flash_grads(*(t.float().numpy()
                                    for t in (tq, tk, tv, tdo)),
                                  causal=True, chunk=64)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        share = float(np.abs(g.float().numpy() - r).max()
                      / np.abs(r).max())
        print(f"bf16 wgmma backward emulation, d={d}, {name}: max |err| "
              f"{share:.3g} of max |grad| (tolerance {BF16_TOL})")
        assert share <= BF16_TOL
    # Rounding dS, and P, is a real departure, not a no-op.
    exact_ds = tc_flash_bwd_emulation(tq, tk, tv, o, tdo, lse,
                                      causal=True, round_ds=False)
    exact_p = tc_flash_bwd_emulation(tq, tk, tv, o, tdo, lse, causal=True,
                                     round_p=False)
    assert not torch.equal(got[0], exact_ds[0])
    assert not torch.equal(got[1], exact_ds[1])
    assert not torch.equal(got[2], exact_p[2])


def test_flash_backward_variant_by_type():
    """The backward counts launches per variant, and each type's C
    entry reaches its variant's kernels: bf16 the tensor-core
    `tc::dispatch`, float32 the SIMT `dispatch`."""
    assert set(T_flash.attend_backward.launches_by_variant) == \
        {"wgmma", "simt"}
    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for dtype, var in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        assert T_flash.variant(dtype) == var
        entry = T_flash._BWD_ENTRY[dtype]
        body = text.split(f'extern "C" int {entry}(')[1].split("}")[0]
        assert ("tc::dispatch(" in body) == (var == "wgmma")
        assert "dispatch(" in body
    cases = CHIP_SMOKE.FLASH_BWD_CASES
    assert (1, 16, 8, 130, 4133, 128, True, 4003) in cases
    assert {c[5] for c in cases} == set(T_flash.HEAD_DIMS)


def test_flash_backward_cases_hold_every_training_shape():
    """Each attention call of chip_smoke's family training phases, at
    batch 2 with the config's query and KV heads, is a case that
    `flash_bwd_vs_plain` holds against the plain backward."""
    from repro_torch import configs

    cases = set(CHIP_SMOKE.FLASH_BWD_CASES)
    shapes = 0
    for arch, _, _, calls in CHIP_SMOKE.TRAIN_FAMILIES:
        cfg = configs.get_config(arch)
        for (sq, sk, d, causal), _ in calls:
            assert d == cfg.head_dim
            assert (2, cfg.n_heads, cfg.n_kv_heads, sq, sk, d, causal,
                    0) in cases, (arch, sq, sk, d, causal)
            shapes += 1
    assert shapes == 5


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// changed\n')
    assert build.library_path("k") not in (first, second)
    assert first.parent == build.BUILD_DIR
