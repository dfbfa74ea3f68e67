"""The port's MoE, Mamba-2 SSD and cross-attention blocks against the
reference, on the CPU.

Parameters come from the reference's init (`moe_init`, `ssm_init`,
`attention_init`) as numpy, perturbed where the init is constant (SSM
dt bias and skip, norm scales) so that parity covers them; inputs are
drawn with numpy.  Tolerances, largest errors measured in brackets:

- `moe_apply` in float32 (reduced Phi-3.5-MoE, 2 x 32 tokens): the
  router's top-k indices equal (ties to the lower index, as
  `jax.lax.top_k`), outputs and aux within rtol/atol 1e-5 [4.8e-7;
  aux equal], with ample capacity and with a capacity factor that
  drops tokens; in bfloat16 compute (reduced Jamba's experts) within
  the LM's bfloat16 bounds (0.05) [0.0039].
- `ssd_forward` and `ssd_decode` in float32 (reduced Mamba-2, 2 x 128
  tokens, 2 chunks): within 1e-4 [9.1e-6 forward; 4.5e-6 outputs and
  1.3e-5 states stepping]; the port's chunked forward equals stepping
  its own recurrence within 1e-4 [1.6e-5].
- Cross `attention_apply` (text queries over image keys: no RoPE, not
  causal) within 1e-5 [1.8e-7].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as R_get_config
from repro.models import layers as R_L
from repro.models import moe as R_M
from repro.models import ssm as R_S
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers as T_L
from repro_torch.models import moe as T_M
from repro_torch.models import ssm as T_S

F32 = dict(rtol=1e-5, atol=1e-5)
SSM_F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.05)


def _configs(arch, compute="float32", **kw):
    return (dataclasses.replace(R_get_config(arch, reduced=True),
                                compute_dtype=compute, **kw),
            dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype=compute, **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both_trees(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(convert._tensor_from_numpy, tree))


def _input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25],
                         ids=["no_drops", "default", "drops"])
def test_moe_apply_matches_reference(capacity_factor):
    rcfg, cfg = _configs("phi3_5_moe_42b", capacity_factor=capacity_factor)
    params = _np_tree(R_M.moe_init(jax.random.PRNGKey(0), rcfg)[0])
    jp, tp = _both_trees(params)
    jx, tx = _input((2, 32, cfg.d_model), 1)
    r_out, r_aux = R_M.moe_apply(jp, rcfg, jx)
    t_out, t_aux = T_M.moe_apply(tp, cfg, tx)
    _close(t_out, r_out, F32)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **F32)
    # The routing is exact: the reference's top-k of its float32 probs.
    probs = jax.nn.softmax((jx @ jp["router"]).astype(jnp.float32), -1)
    r_w, r_i = jax.lax.top_k(probs, cfg.experts_per_token)
    _, t_w, t_i = T_M.route(tp, cfg, tx)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(r_i))
    if capacity_factor == 0.25:
        # Some assignments are dropped: the capacity binds.
        cap = T_M._capacity(cfg, 32)
        counts = np.bincount(np.asarray(r_i[0]).ravel(),
                             minlength=cfg.n_experts)
        assert counts.max() > cap


def test_moe_dispatch_drops_ranks_at_capacity():
    """Expert 0 takes tokens 0, 1, 2 with capacity 2: token 2 is
    dropped, not written over slot 1; empty slots read the padding row
    T with weight 0."""
    gate_i = torch.tensor([[[0], [0], [0], [1]]])
    gate_w = torch.tensor([[[0.5], [0.25], [0.125], [1.0]]])
    idx, w = T_M.dispatch(gate_i, gate_w, n_experts=3, cap=2)
    assert idx.tolist() == [[[0, 1], [3, 4], [4, 4]]]
    assert w.tolist() == [[[0.5, 0.25], [1.0, 0.0], [0.0, 0.0]]]


def test_moe_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.125, 0.25, 0.125]], np.float32)
    r_w, r_i = jax.lax.top_k(jnp.asarray(probs), 3)
    t_w, t_i = T_M.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(r_w))


def test_moe_apply_bf16_within_tolerance():
    rcfg, cfg = _configs("jamba_v0_1_52b", "bfloat16")
    params = _np_tree(R_M.moe_init(jax.random.PRNGKey(1), rcfg)[0])
    jp, tp = _both_trees(params)
    jx, tx = _input((2, 16, cfg.d_model), 2)
    r_out, r_aux = R_M.moe_apply(jp, rcfg, jx.astype(jnp.bfloat16))
    t_out, t_aux = T_M.moe_apply(tp, cfg, tx.bfloat16())
    assert t_out.dtype == torch.bfloat16
    _close(t_out, r_out, BF16)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **BF16)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssm_params(rcfg, seed=0):
    params = _np_tree(R_S.ssm_init(jax.random.PRNGKey(seed), rcfg)[0])
    rng = np.random.default_rng(seed + 10)
    nh = rcfg.ssm_heads
    params["dt_bias"] = (0.5 * rng.standard_normal(nh)).astype(np.float32)
    params["d_skip"] = (1 + 0.1 * rng.standard_normal(nh)).astype(np.float32)
    params["norm"]["scale"] = (1 + 0.1 * rng.standard_normal(
        params["norm"]["scale"].shape)).astype(np.float32)
    return params


def test_ssd_forward_matches_reference():
    rcfg, cfg = _configs("mamba2_1_3b")
    jp, tp = _both_trees(_ssm_params(rcfg))
    jx, tx = _input((2, 2 * cfg.ssm_chunk, cfg.d_model), 3)
    _close(T_S.ssd_forward(tp, cfg, tx), R_S.ssd_forward(jp, rcfg, jx),
           SSM_F32)


def test_ssd_decode_matches_reference_and_the_chunked_forward():
    rcfg, cfg = _configs("mamba2_1_3b")
    jp, tp = _both_trees(_ssm_params(rcfg, seed=1))
    s = 2 * cfg.ssm_chunk
    jx, tx = _input((2, s, cfg.d_model), 4)
    shape = (2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    jh, th = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    step = jax.jit(lambda h, x: R_S.ssd_decode(jp, rcfg, x, h))
    ys = []
    for t in range(s):
        jy, jh = step(jh, jx[:, t:t + 1])
        ty, th = T_S.ssd_decode(tp, cfg, tx[:, t:t + 1], th)
        ys.append(ty)
        if t % 32 == 31:
            _close(ty, jy, SSM_F32)
            _close(th, jh, SSM_F32)
    # The chunked forward is the recurrence, in another order.
    torch.testing.assert_close(torch.cat(ys, dim=1),
                               T_S.ssd_forward(tp, cfg, tx), **SSM_F32)


def test_ssd_forward_needs_whole_chunks():
    _, cfg = _configs("mamba2_1_3b")
    gen = torch.Generator("cpu").manual_seed(0)
    params = T_S.ssm_init(gen, cfg)
    x = torch.zeros((1, cfg.ssm_chunk + 1, cfg.d_model))
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        T_S.ssd_forward(params, cfg, x)


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------

def test_cross_attention_apply_matches_reference():
    rcfg, cfg = _configs("llama_3_2_vision_90b")
    params = _np_tree(R_L.attention_init(jax.random.PRNGKey(2), rcfg,
                                         cross=True)[0])
    jp, tp = _both_trees(params)
    jx, tx = _input((2, 7, cfg.d_model), 5)
    jimg, timg = _input((2, cfg.n_image_tokens, cfg.d_model), 6)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (2, 7))
    zeros = np.zeros((2, cfg.n_image_tokens), np.int32)
    ref = R_L.attention_apply(jp, rcfg, jx, jnp.asarray(pos),
                              kv_x=jimg, kv_positions=jnp.asarray(zeros))
    got = T_L.attention_apply(tp, cfg, tx, torch.from_numpy(pos.copy()),
                              kv_x=timg, kv_positions=torch.from_numpy(zeros))
    _close(got, ref, F32)
    # Not causal and without RoPE: the text positions do not matter.
    shifted = T_L.attention_apply(tp, cfg, tx,
                                  torch.from_numpy(pos.copy()) + 100,
                                  kv_x=timg,
                                  kv_positions=torch.from_numpy(zeros))
    torch.testing.assert_close(shifted, got, rtol=0, atol=0)
