"""The port's LM for the MoE, SSM, hybrid, vision-language and audio
families against the reference, on the CPU: the reduced forms of
Phi-3.5-MoE, Kimi K2, Mamba-2, Jamba, Llama-3.2-Vision and
HuBERT-XLarge.

Parameters come from the reference's `LM.init` (norm scales, QKV biases
and the SSM's dt bias and skip perturbed off their constant init so
that parity covers them), carried over with
`convert.lm_params_from_numpy`; tokens, frames and image embeddings
are drawn with numpy.  Compute is float32 unless a test says otherwise.
Tolerances, largest errors measured in brackets:

- the init tree: the reference's names, shapes and types, exactly;
- prefill (2 x 128 tokens: two SSD chunks of 64): last logits within
  rtol/atol 1e-4 [3.7e-6], K/V stacks within 1e-4 [2.1e-5]; the SSM
  state is not part of prefill's cache, as in the reference;
- 8 teacher-forced decode steps: logits each step [2.2e-6], and K/V
  and SSM states after [5.2e-6], within 1e-4;
- greedy decoding, prompt 5 + 7 tokens: equal tokens;
- `train_loss` (2 x 128): loss within rtol 1e-5 [2.1e-7] with the MoE
  aux loss within 1e-5 [2.4e-7], and every gradient leaf within 1e-4
  of its largest magnitude [5.8e-5] (bfloat16 leaves, the
  bf16-parameter configs: within one bfloat16 step, 2**-7 [5.9e-3]);
  the encoder's loss reads `labels`;
- bfloat16 compute (prefill of the MoE and hybrid families, where
  near-ties in the router could route a token elsewhere): logits within
  the LM's bfloat16 bounds, 0.05 [0.027];
- `make_train_step`, 3 steps on the config's optimizer (AdamW; Adafactor
  for Kimi K2 and Llama-3.2-Vision) in float32 compute and parameters,
  on the data pipeline's batches (2 x 128): losses and gradient norms
  rtol 1e-5, parameters within 1e-4 (rtol and atol), the bounds of
  tests/test_torch_train.py's dense case; Kimi K2 and Llama-3.2-Vision
  as they ship (bf16 parameters and compute, lr 3e-4, warmup 20):
  losses rtol 1e-3 [2.7e-4], gradient norms rtol 2**-7 [9.1e-4], each
  parameter leaf within 2**-7 of its largest magnitude [2.8e-3].
Largest errors over the six configs, from one CPU run.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as R_get_config
from repro.data.pipeline import DataConfig as R_DataConfig
from repro.data.pipeline import make_batch as R_make_batch
from repro.models.lm import build_model as R_build
from repro.serve.serve_step import greedy_decode as R_greedy
from repro.train.optimizer import OptConfig as R_OptConfig
from repro.train.train_step import TrainConfig as R_TrainConfig
from repro.train.train_step import make_train_step as R_make_train_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import abstract_params, build_model
from repro_torch.serve.serve_step import greedy_decode
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

FAMILIES = ["phi3_5_moe_42b", "kimi_k2_1t", "mamba2_1_3b",
            "jamba_v0_1_52b", "llama_3_2_vision_90b", "hubert_xlarge"]
LM_F32 = dict(rtol=1e-4, atol=1e-4)
LM_BF16 = dict(rtol=0.05, atol=0.05)
LOSS_F32 = dict(rtol=1e-5, atol=1e-5)
# A gradient leaf's largest error, as a share of its largest magnitude:
# float32 leaves 1e-4; bfloat16 leaves (the bf16-parameter configs)
# one bfloat16 step, 2**-7, as both packages round the gradient.
GRAD_SHARE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
STEP_LOSS = dict(rtol=1e-5, atol=0.0)
STEP_PARAMS = dict(rtol=1e-4, atol=1e-4)
SEQ = 128


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small CPU operations: one intra-op thread keeps them fast
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed_params(rcfg, seed=0):
    params, _ = R_build(rcfg).init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        name = path[-1].key
        if name in ("scale", "d_skip"):
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name in ("bq", "bk", "bv", "dt_bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


@functools.lru_cache(maxsize=None)
def _setup(arch, compute="float32"):
    """(reference LM, its params as jax arrays, port LM with the same
    params)."""
    rcfg = dataclasses.replace(R_get_config(arch, reduced=True),
                               compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute)
    params = _perturbed_params(rcfg)
    port = convert.lm_params_from_numpy(cfg, params, device="cpu")
    return R_build(rcfg), jax.tree.map(jnp.asarray, params), port


def _batch(cfg, b, s, seed=1):
    """The same batch for both packages: (jax dict, torch dict)."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        arrs = {"frames": rng.standard_normal((b, s, cfg.d_model))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (b, s))
                .astype(np.int32)}
    else:
        arrs = {"tokens": rng.integers(1, cfg.vocab_size, (b, s))
                .astype(np.int32)}
        if cfg.modality == "vision+text":
            arrs["image_embeds"] = rng.standard_normal(
                (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _image(cfg, b, seed=2):
    if cfg.modality != "vision+text":
        return None, None
    img = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(img), torch.from_numpy(img)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_every_arch_builds_on_the_cpu():
    """All ten configs build; each family's slot kinds are there."""
    assert tuple(ARCH_IDS) == tuple(R_ARCH_IDS)
    kinds = {}
    for arch in ARCH_IDS:
        model = build_model(get_config(arch, reduced=True), device="cpu")
        kinds[arch] = {(s.kind, s.moe, s.cross) for s in model.slots}
    assert kinds["mamba2_1_3b"] == {("ssm", False, False)}
    assert ("attn", True, False) in kinds["jamba_v0_1_52b"]
    assert ("ssm", False, False) in kinds["jamba_v0_1_52b"]
    assert ("attn", False, True) in kinds["llama_3_2_vision_90b"]
    assert kinds["kimi_k2_1t"] == {("attn", True, False)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_tree_matches_reference(arch):
    rcfg, cfg = R_get_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    r_tree = jax.eval_shape(lambda k: R_build(rcfg).init(k)[0],
                            jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator("cpu").manual_seed(1))
    r_leaves = jax.tree_util.tree_leaves_with_path(r_tree)
    for tree in (model.params, abstract_params(cfg)):
        t_leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [jax.tree_util.keystr(p) for p, _ in t_leaves] == \
            [jax.tree_util.keystr(p) for p, _ in r_leaves]
        for (_, t), (_, r) in zip(t_leaves, r_leaves):
            assert tuple(t.shape) == r.shape
            assert str(t.dtype).split(".")[-1] == str(r.dtype)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch):
    ref, params, port = _setup(arch)
    jb, tb = _batch(port.cfg, 2, SEQ)
    r_logits, r_cache = jax.jit(ref.prefill)(params, jb)
    t_logits, t_cache = port.prefill(tb)
    assert t_logits.dtype == torch.float32
    assert t_logits.shape == r_logits.shape
    _close(t_logits, r_logits, LM_F32)
    assert r_cache["ssm"] is None and t_cache["ssm"] is None
    assert len(t_cache["kv"]) == len(r_cache["kv"])
    for (tk, tv), (rk, rv) in zip(t_cache["kv"], r_cache["kv"]):
        assert tuple(tk.shape) == rk.shape
        _close(tk, rk, LM_F32)
        _close(tv, rv, LM_F32)


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "jamba_v0_1_52b"])
def test_bf16_prefill_within_tolerance(arch):
    ref, params, port = _setup(arch, "bfloat16")
    jb, tb = _batch(port.cfg, 2, SEQ, seed=4)
    r_logits, _ = jax.jit(ref.prefill)(params, jb)
    t_logits, _ = port.prefill(tb)
    _close(t_logits, r_logits, LM_BF16)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_reference(arch):
    """8 teacher-forced decode steps: logits each step; K/V and SSM
    states after."""
    ref, params, port = _setup(arch)
    b, n = 2, 8
    toks = np.random.default_rng(3).integers(1, port.cfg.vocab_size, (b, n))
    jimg, timg = _image(port.cfg, b)
    r_cache = ref.init_cache(b, n + 2, dtype=jnp.float32)
    t_cache = port.init_cache(b, n + 2, dtype=torch.float32)
    step = jax.jit(ref.decode_step)
    for pos in range(n):
        tok = toks[:, pos:pos + 1]
        r_logits, r_cache = step(params, r_cache, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(pos), image_embeds=jimg)
        t_logits, t_cache = port.decode_step(t_cache, torch.from_numpy(tok),
                                             pos, image_embeds=timg)
        _close(t_logits, r_logits, LM_F32)
    assert set(t_cache) == set(r_cache)
    for slot, leaves in r_cache.items():
        assert set(t_cache[slot]) == set(leaves)
        for name, r in leaves.items():
            assert t_cache[slot][name].dtype == torch.float32
            _close(t_cache[slot][name], r, LM_F32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_decode_matches_reference(arch):
    ref, params, port = _setup(arch)
    toks = np.random.default_rng(5).integers(1, port.cfg.vocab_size, (2, 5))
    jimg, timg = _image(port.cfg, 2, seed=6)
    r_out = np.asarray(R_greedy(ref, params, jnp.asarray(toks, jnp.int32), 7,
                                image_embeds=jimg))
    t_out = greedy_decode(port, toks, 7, device="cpu", image_embeds=timg)
    assert t_out.shape == r_out.shape == (2, 12)
    np.testing.assert_array_equal(t_out.numpy(), r_out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_gradients_match_reference(arch):
    ref, params, port = _setup(arch)
    jb, tb = _batch(port.cfg, 2, SEQ, seed=7)
    (r_loss, r_met), r_grads = jax.value_and_grad(
        lambda p: ref.train_loss(p, jb), has_aux=True)(params)
    loss, met = port.train_loss(tb)
    # HuBERT's token table is never read: no gradient (the reference's
    # is zero).
    grads = torch.autograd.grad(loss, tree_leaves(port.params),
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(r_loss), **LOSS_F32)
    np.testing.assert_allclose(met["nll"].item(), float(r_met["nll"]),
                               **LOSS_F32)
    np.testing.assert_allclose(float(torch.as_tensor(met["aux"]).detach()),
                               float(r_met["aux"]),
                               **LOSS_F32)
    if port.cfg.n_experts:
        assert float(r_met["aux"]) > 0
    r_leaves = jax.tree.leaves(r_grads)
    assert len(grads) == len(r_leaves)
    for leaf, t, r in zip(tree_leaves(port.params), grads, r_leaves):
        r = np.asarray(r, np.float32)
        if t is None:
            assert not r.any()
            continue
        assert t.dtype == leaf.dtype
        share = GRAD_SHARE[leaf.dtype]
        err = np.abs(t.float().numpy() - r).max()
        assert err <= share * np.abs(r).max(), (err, np.abs(r).max())


def _three_steps(arch, lr, warmup, **kw):
    """3 steps of `make_train_step` on the config's optimizer (config
    fields `kw` replaced in both packages) and the reference's jitted
    step, on the same perturbed parameters and the data pipeline's
    batches (HuBERT's frames and labels, the VLM's image embeddings):
    (port params, reference params, [(port, reference) loss and gradient
    norm of each step])."""
    rcfg = dataclasses.replace(R_get_config(arch, reduced=True), **kw)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    assert cfg.optimizer == rcfg.optimizer
    params = _perturbed_params(rcfg)
    port = convert.lm_params_from_numpy(cfg, params, device="cpu")
    rmodel = R_build(rcfg)
    r_params = jax.tree.map(jnp.asarray, params)
    r_tcfg = R_TrainConfig(opt=R_OptConfig(lr=lr, warmup_steps=warmup))
    t_tcfg = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=warmup))
    r_step, r_init = R_make_train_step(rmodel, r_tcfg)
    r_step = jax.jit(r_step)
    r_opt = r_init(r_tcfg.opt, r_params)
    t_step, _ = make_train_step(port, t_tcfg)
    t_params, t_opt = init_train_state(port, t_tcfg)
    data = R_DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=2, modality=cfg.modality,
                        d_model=cfg.d_model,
                        n_image_tokens=cfg.n_image_tokens)
    metrics = []
    for step in range(3):
        arrs = R_make_batch(data, step)
        r_params, r_opt, rmet = r_step(
            r_params, r_opt, {k: jnp.asarray(v) for k, v in arrs.items()})
        t_params, t_opt, tmet = t_step(
            t_params, t_opt,
            {k: torch.from_numpy(v) for k, v in arrs.items()})
        metrics += [(tmet[key].item(), float(rmet[key]))
                    for key in ("loss", "grad_norm")]
    assert int(t_opt["step"]) == int(r_opt["step"]) == 3
    r_leaves = jax.tree.leaves(r_params)
    assert len(tree_leaves(t_params)) == len(r_leaves)
    return tree_leaves(t_params), r_leaves, metrics


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_three_steps_match_reference(arch):
    """3 steps on the config's optimizer in float32 compute and
    parameters."""
    t_leaves, r_leaves, metrics = _three_steps(
        arch, 1e-3, 2, compute_dtype="float32", param_dtype="float32")
    for got, want in metrics:
        np.testing.assert_allclose(got, want, **STEP_LOSS)
    for t, r in zip(t_leaves, r_leaves):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(r),
                                   **STEP_PARAMS)


@pytest.mark.parametrize("arch", ["kimi_k2_1t", "llama_3_2_vision_90b"])
def test_bf16_adafactor_steps_match_reference(arch):
    """The bf16-parameter configs as they ship (bf16 compute and
    parameters, Adafactor), 3 steps at the training CLI's lr and warmup:
    losses within the bf16 bound of tests/test_torch_train.py (rtol
    1e-3); gradient norms, and each parameter leaf as a share of its
    largest magnitude, within one bfloat16 step, 2**-7."""
    t_leaves, r_leaves, metrics = _three_steps(arch, 3e-4, 20)
    for (loss, r_loss), (gnorm, r_gnorm) in zip(metrics[::2], metrics[1::2]):
        np.testing.assert_allclose(loss, r_loss, rtol=1e-3)
        np.testing.assert_allclose(gnorm, r_gnorm,
                                   rtol=GRAD_SHARE[torch.bfloat16])
    for t, r in zip(t_leaves, r_leaves):
        assert t.dtype == torch.bfloat16
        r = np.asarray(r, np.float32)
        err = np.abs(t.detach().float().numpy() - r).max()
        assert err <= GRAD_SHARE[torch.bfloat16] * np.abs(r).max(), (
            err, np.abs(r).max())


def test_encoder_loss_reads_the_labels():
    """HuBERT's loss is per-position classification of `labels`: other
    labels, another loss; the tokens are not read."""
    _, _, port = _setup("hubert_xlarge")
    _, tb = _batch(port.cfg, 2, 64)
    loss, _ = port.train_loss(tb)
    flipped = dict(tb, labels=(tb["labels"] + 1) % port.cfg.vocab_size)
    assert port.train_loss(flipped)[0].item() != loss.item()


def test_vlm_without_image_embeddings_raises():
    """The reference's serve CLI gives the VLM no image embeddings, and
    its decode step then fails; the port names what is missing."""
    _, _, port = _setup("llama_3_2_vision_90b")
    _, tb = _batch(port.cfg, 1, 16)
    del tb["image_embeds"]
    with pytest.raises(ValueError, match="image embeddings"):
        port.prefill(tb)
    cache = port.init_cache(1, 4)
    with pytest.raises(ValueError, match="image embeddings"):
        port.decode_step(cache, torch.ones((1, 1), dtype=torch.int64), 0)


def test_reference_vlm_decode_without_image_embeddings_fails():
    """The fault the port names: the reference's serve CLI
    (`repro.launch.serve`) calls `decode_step` without image
    embeddings, and for the VLM that step fails on the missing
    embeddings (`img` is None in its cross slot)."""
    ref, params, port = _setup("llama_3_2_vision_90b")
    cache = ref.init_cache(1, 4, dtype=jnp.float32)
    with pytest.raises(AttributeError):
        ref.decode_step(params, cache, jnp.ones((1, 1), jnp.int32),
                        jnp.int32(0))
