"""The port's dense LM serving path against the reference, on the CPU.

- Layers (`rmsnorm`, `rope`, `attention_qkv`, the four MLP activations,
  `embed`/`unembed`) at float32 rtol 1e-5.
- The model: parameters drawn by the reference's `LM.init` (norm scales
  and biases perturbed so they matter), carried over with
  `convert.lm_params_from_numpy`; `prefill`, 8 `decode_step`s and
  `greedy_decode` against the reference's.  With compute in float32
  logits and caches agree to 1e-4 (largest error measured 1.7e-6) and
  greedy tokens are equal.  With the production bfloat16 compute,
  logits agree to 0.05 (largest errors measured on these inputs: 0.017
  after prefill, 0.023 over the decode steps; the reference's own
  decode-vs-prefill test allows 0.15) and K/V caches to 0.02 + 2%
  (largest 0.031: one bfloat16 rounding step of an entry near 5).
- The port's init: the reference's tree names, shapes and types.
- The serve CLI on the CPU, and `--ckpt-dir` on a checkpoint the
  reference wrote.  The other families are held to the reference in
  tests/test_torch_lm_families.py.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as R_get_config
from repro.models import layers as R_L
from repro.models.lm import build_model as R_build
from repro.serve.serve_step import greedy_decode as R_greedy
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers as T_L
from repro_torch.models.lm import abstract_params, build_model
from repro_torch.serve.serve_step import greedy_decode

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-6)        # layer-level, float32
LM_F32 = dict(rtol=1e-4, atol=1e-4)     # 2-layer model, float32
LM_BF16 = dict(rtol=0.05, atol=0.05)    # 2-layer model, bfloat16 logits
KV_BF16 = dict(rtol=0.02, atol=0.02)    # bfloat16 K/V caches


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _perturbed_params(cfg, seed=0):
    """The reference's init as numpy, with norm scales and QKV biases
    moved off their constant init so that parity covers them."""
    params, _ = R_build(cfg).init(jax.random.PRNGKey(seed))
    params = _np_tree(params)
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        name = path[-1].key
        if name == "scale":
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


def _both(x, jdt=jnp.float32, tdt=torch.float32):
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 4, 6, 32)).astype(np.float32))
    js, ts = _both(rng.standard_normal(32).astype(np.float32))
    _close(T_L.rmsnorm({"scale": ts}, tx), R_L.rmsnorm({"scale": js}, jx),
           F32)
    pos = rng.integers(0, 5000, (2, 1, 6)).astype(np.int32)
    jp, tp = jnp.asarray(pos), torch.from_numpy(pos)
    for theta in (10000.0, 1e6):
        _close(T_L.rope(tx, tp, theta), R_L.rope(jx, jp, theta), F32)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_7b"])
def test_attention_qkv(arch):
    """qwen3: qk-norm; qwen2: QKV bias."""
    cfg = _f32(get_config(arch, reduced=True))
    rcfg = _f32(R_get_config(arch, reduced=True))
    slot = _perturbed_params(rcfg)["blocks"]["slot0"]["attn"]
    p = jax.tree.map(lambda a: a[0], slot)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 5, cfg.d_model))
                   .astype(np.float32))
    pos = np.broadcast_to(np.arange(3, 8, dtype=np.int32), (2, 5))
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    for t, r in zip(T_L.attention_qkv(tp, cfg, tx, tx, tpos, tpos),
                    R_L.attention_qkv(jp, rcfg, jx, jx, jpos, jpos)):
        _close(t, r, F32)
    _close(T_L.attention_apply(tp, cfg, tx, tpos),
           R_L.attention_apply(jp, rcfg, jx, jpos), F32)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu2",
                                        "gelu"])
def test_mlp_activations(activation):
    cfg = dataclasses.replace(_f32(get_config("qwen3_0_6b", reduced=True)),
                              activation=activation)
    rcfg = dataclasses.replace(
        _f32(R_get_config("qwen3_0_6b", reduced=True)),
        activation=activation)
    p = _np_tree(R_L.mlp_init(jax.random.PRNGKey(3), rcfg)[0])
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((2, 3, cfg.d_model))
                   .astype(np.float32))
    _close(T_L.mlp_apply(jax.tree.map(torch.from_numpy, p), cfg, tx),
           R_L.mlp_apply(jax.tree.map(jnp.asarray, p), rcfg, jx), F32)


def test_embed_unembed():
    cfg = _f32(get_config("qwen3_0_6b", reduced=True))
    rcfg = _f32(R_get_config("qwen3_0_6b", reduced=True))
    p = _np_tree(R_L.embedding_init(jax.random.PRNGKey(4), rcfg)[0])
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    emb_t = T_L.embed(tp, cfg, torch.from_numpy(toks))
    emb_r = R_L.embed(jp, rcfg, jnp.asarray(toks, jnp.int32))
    _close(emb_t, emb_r, F32)
    out = T_L.unembed(tp, cfg, emb_t)
    assert out.dtype == torch.float32
    _close(out, R_L.unembed(jp, rcfg, emb_r), F32)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _models(arch, compute_dtype):
    """(reference LM, its params, port LM holding the same params)."""
    rcfg = dataclasses.replace(R_get_config(arch, reduced=True),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute_dtype)
    params = _perturbed_params(rcfg)
    port = convert.lm_params_from_numpy(cfg, params, device="cpu")
    return R_build(rcfg), jax.tree.map(jnp.asarray, params), port


def _tokens(cfg, shape, seed=1):
    toks = np.random.default_rng(seed).integers(1, cfg.vocab_size, shape)
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


PREFILL_CASES = [("qwen3_0_6b", "float32"), ("qwen3_0_6b", "bfloat16"),
                 ("qwen2_7b", "float32"), ("gemma_7b", "float32"),
                 ("nemotron_4_340b", "float32")]


@pytest.mark.parametrize("arch,compute_dtype", PREFILL_CASES)
def test_prefill_matches_reference(arch, compute_dtype):
    ref, params, port = _models(arch, compute_dtype)
    jt, tt = _tokens(port.cfg, (2, 12))
    r_logits, r_cache = jax.jit(ref.prefill)(params, {"tokens": jt})
    t_logits, t_cache = port.prefill({"tokens": tt})
    f32 = compute_dtype == "float32"
    assert t_logits.shape == r_logits.shape
    assert t_logits.dtype == torch.float32
    _close(t_logits, r_logits, LM_F32 if f32 else LM_BF16)
    (rk, rv), = r_cache["kv"]
    (tk, tv), = t_cache["kv"]
    assert tuple(tk.shape) == rk.shape and tuple(tv.shape) == rv.shape
    _close(tk, rk, LM_F32 if f32 else KV_BF16)
    _close(tv, rv, LM_F32 if f32 else KV_BF16)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(compute_dtype):
    """8 teacher-forced decode steps: logits each step, caches after."""
    ref, params, port = _models("qwen3_0_6b", compute_dtype)
    b, n = 2, 8
    jt, tt = _tokens(port.cfg, (b, n), seed=2)
    f32 = compute_dtype == "float32"
    cdt = (jnp.float32, torch.float32) if f32 else \
        (jnp.bfloat16, torch.bfloat16)
    r_cache = ref.init_cache(b, n + 2, dtype=cdt[0])
    t_cache = port.init_cache(b, n + 2, dtype=cdt[1])
    step = jax.jit(ref.decode_step)
    for pos in range(n):
        r_logits, r_cache = step(params, r_cache, jt[:, pos:pos + 1],
                                 jnp.int32(pos))
        t_logits, t_cache = port.decode_step(t_cache, tt[:, pos:pos + 1],
                                             pos)
        _close(t_logits, r_logits, LM_F32 if f32 else LM_BF16)
    for name in ("k", "v"):
        _close(t_cache["slot0"][name], r_cache["slot0"][name],
               LM_F32 if f32 else KV_BF16)


def test_greedy_decode_matches_reference():
    """Float32 compute, the default bfloat16 cache: equal tokens."""
    ref, params, port = _models("qwen3_0_6b", "float32")
    jt, tt = _tokens(port.cfg, (2, 5), seed=3)
    r_out = np.asarray(R_greedy(ref, params, jt, 7))
    t_out = greedy_decode(port, tt, 7, device="cpu")
    assert t_out.shape == r_out.shape == (2, 12)
    np.testing.assert_array_equal(t_out.numpy(), r_out)


def test_greedy_decode_checks_device():
    port = build_model(get_config("qwen3_0_6b", reduced=True), device="cpu")
    with pytest.raises(ValueError, match="model on cpu"):
        greedy_decode(port, np.ones((1, 2), np.int64), 1, device="meta")


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_7b", "gemma_7b",
                                  "nemotron_4_340b"])
def test_init_tree_matches_reference(arch):
    rcfg = R_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    r_tree = jax.eval_shape(lambda k: R_build(rcfg).init(k)[0],
                            jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator("cpu").manual_seed(1))
    for tree in (model.params, abstract_params(cfg)):
        r_leaves = jax.tree_util.tree_leaves_with_path(r_tree)
        t_leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(p) for p, _ in t_leaves] == \
            [jax.tree_util.keystr(p) for p, _ in r_leaves]
        for (_, t), (_, r) in zip(t_leaves, r_leaves):
            assert tuple(t.shape) == r.shape
            assert str(t.dtype).split(".")[-1] == str(r.dtype)


def test_lm_params_from_numpy_rejects_wrong_tree():
    cfg = get_config("qwen3_0_6b", reduced=True)
    params = _np_tree(R_build(R_get_config("qwen3_0_6b", reduced=True))
                      .init(jax.random.PRNGKey(0))[0])
    params["embed"]["tok"] = params["embed"]["tok"][:, :-1]
    with pytest.raises(ValueError, match="embed/tok"):
        convert.lm_params_from_numpy(cfg, params, device="cpu")
    del params["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_numpy(cfg, params, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("qwen3_0_6b", reduced=True))


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3_0_6b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "4", "--gen", "6"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "2 seqs x 10 tokens" in proc.stdout
    assert "tok/s" in proc.stdout


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "kimi_k2_1t"])
def test_serve_cli_restores_a_reference_checkpoint(arch, tmp_path):
    """`--ckpt-dir` on a checkpoint the reference's `checkpoint.save`
    wrote (Kimi K2's parameters are bfloat16): the step is logged as
    the reference logs it, and the served tokens equal those of a port
    model built from the same parameters."""
    from repro.checkpoint import checkpoint as R_ckpt
    from repro_torch.launch import serve

    rcfg = R_get_config(arch, reduced=True)
    params = _np_tree(R_build(rcfg).init(jax.random.PRNGKey(5))[0])
    R_ckpt.save(tmp_path, 7, {"params": params, "opt": {"step": np.int32(7)}})
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "6", "--seed", "3"]
    logs = []
    seq, _ = serve.run(serve.parse_args(argv + ["--ckpt-dir", str(tmp_path)]),
                       clock=lambda: 0.0, log=logs.append)
    assert logs == [f"[serve] restored step 7 from {tmp_path}"]
    args = serve.parse_args(argv)
    cfg = get_config(arch, reduced=True)
    direct = convert.lm_params_from_numpy(cfg, params, device="cpu")
    want, _ = serve.decode(direct, serve.prompts_for(args, cfg.vocab_size),
                           args.gen, clock=lambda: 0.0)
    assert seq.shape == (2, 10)
    torch.testing.assert_close(seq, want, rtol=0, atol=0)
    # Not the seed's model: the parameters came from the checkpoint.
    seeded, _ = serve.run(args, clock=lambda: 0.0)
    assert not torch.equal(seeded, seq)
