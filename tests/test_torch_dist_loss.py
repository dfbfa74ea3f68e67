"""The training loss over the vocabulary's shards
(`layers.unembed(vocab_shards=True)`, `layers.vocab_parallel_nll`) and
the row-parallel partial sums reduced at their product
(`layers.row_parallel_product`), on the CPU.

- Gloo worlds of (1, 1, 2) and (1, 2, 2), a process a rank
  (`tests/_torch_dist_harness.py`): the NLL of the logits of x (4, 16,
  64) and a (64, V) table, placed as `LM.train_loss` places them,
  equals `F.log_softmax` and `gather` on one process, its mean and the
  gradients of x and the table too, in three cases: a vocabulary that
  16 divides (512: the table's columns over "model"), one that it does
  not (131: d_model sharded, so each rank computes its own block of
  the vocabulary, 66 and 65 columns over two ranks), and the encoder's
  labels (every position, no shift).  The logits stay sharded by
  vocabulary, and no collective carries a (rows, S, V) tensor or its
  block.
- The reduced HuBERT with that odd vocabulary, the encoder whose
  vocabulary (504) the "model" axis does not divide, on (1, 2, 2): the
  sharded loss equals the reference's single-device `train_loss`, and
  the gradients and three AdamW steps equal the single-process port's.
- The census of a reduced bf16 training step over a fake gloo mesh of
  (data 2, model 2), Qwen3 and Mamba-2 at an odd vocabulary: no
  collective has the vocabulary or its block as the last dim of a
  tensor of rank 3 or more, and no float32 all-reduce carries a
  (rows, S, d_model) activation (the partial sums of `wo` and `w_down`
  are reduced at the product, in bfloat16, and reduce-scattered to the
  residual stream's sequence shards: (rows, S / 2, d_model)).
- On plain tensors the loss is `F.log_softmax` and `gather` bit for
  bit, and `_BlockNLL` on one block is their gradient.

Bounds (`tests/_torch_dist_harness.py`): losses and each NLL rtol 1e-5
(`LOSS_F32`), gradients within 1e-5 of each leaf's largest magnitude
(`GRAD_F32_SHARE`), steps as `assert_steps_match`.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_dist_harness import (GRAD_F32_SHARE, LOSS_F32,
                                 assert_leaves_within_share,
                                 assert_steps_match, reference, run_world,
                                 single_process)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells as T_cells
from repro_torch.models import layers as L

B, S, D = 4, 16, 64
# name -> (vocabulary, causal)
CASES = {"divides": (512, True), "odd": (131, True), "labels": (131, False)}
WORLDS = [(1, 1, 2), (1, 2, 2)]
HUBERT = "hubert_xlarge"
ODD = {"vocab_size": 131}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each case's x, table and targets from `np.random.default_rng`,
    and the npz the worlds read."""
    rng = np.random.default_rng(0)
    arrays = {}
    for name, (vocab, _) in CASES.items():
        arrays[f"{name}/x"] = rng.standard_normal((B, S, D)).astype(
            np.float32)
        arrays[f"{name}/w"] = (rng.standard_normal((D, vocab))
                               / np.sqrt(D)).astype(np.float32)
        arrays[f"{name}/t"] = rng.integers(0, vocab, (B, S))
    path = tmp_path_factory.mktemp("nll") / "inputs.npz"
    np.savez(path, **arrays)
    return str(path), arrays


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's reduced HuBERT at the odd vocabulary: its
    parameters, labels and loss, and the single-process port's run."""
    params, batch, files = reference(HUBERT, tmp_path_factory.mktemp(
        "carried_hubert"), override=ODD)
    files["adam"] = single_process(params, batch, arch=HUBERT,
                                   override=ODD)
    return files


@pytest.fixture(scope="module")
def worlds(inputs, carried, tmp_path_factory):
    """Each world of `WORLDS`, run once on first use: the NLL cases,
    and on (1, 2, 2) the odd-vocabulary HuBERT's parity job."""
    done = {}

    def get(shape):
        if shape not in done:
            jobs = [{"name": "nll", "kind": "nll", "inputs": inputs[0],
                     "cases": [{"name": n, "causal": c}
                               for n, (_, c) in CASES.items()]}]
            if shape == (1, 2, 2):
                jobs.append({"name": "hubert", "kind": "parity",
                             "arch": HUBERT, "override": ODD})
            done[shape] = run_world(shape, jobs, carried,
                                    tmp_path_factory.mktemp(
                                        "world_" + "x".join(map(str, shape))))
        return done[shape]
    return get


def _one_process(arrays: dict, name: str) -> dict:
    """`LM.train_loss`'s unsharded loss on the case's inputs: loss,
    NLL and the gradients of x and the table."""
    causal = CASES[name][1]
    x = torch.from_numpy(arrays[f"{name}/x"]).requires_grad_()
    w = torch.from_numpy(arrays[f"{name}/w"]).requires_grad_()
    t = torch.from_numpy(arrays[f"{name}/t"])
    logits = (x @ w).float()
    if causal:
        logits, t = logits[:, :-1], t[:, 1:]
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                        t[..., None])[..., 0]
    gx, gw = torch.autograd.grad(nll.mean(), [x, w])
    return {"loss": nll.mean().item(), "nll": nll.detach(), "grad_x": gx,
            "grad_w": gw}


@pytest.fixture(scope="module", params=WORLDS,
                ids=["x".join(map(str, m)) for m in WORLDS])
def world(request, worlds):
    return request.param, worlds(request.param)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_nll_matches_one_process(world, inputs, case):
    got, want = world[1]["nll"][case], _one_process(inputs[1], case)
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_F32)
    np.testing.assert_allclose(got["nll"].numpy(), want["nll"].numpy(),
                               **LOSS_F32)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_nll_gradients_match_one_process(world, inputs, case):
    got, want = world[1]["nll"][case], _one_process(inputs[1], case)
    assert_leaves_within_share([got["grad_x"], got["grad_w"]],
                                [want["grad_x"], want["grad_w"]],
                                GRAD_F32_SHARE)


def _vocab_sized(shapes: dict, vocab: int) -> list:
    """The census keys of collectives with a tensor of rank 3 or more
    whose last dim is `vocab` or a block of it over two ranks."""
    sizes = {vocab, vocab // 2, -(-vocab // 2)}
    return [key for key in shapes
            for dims in re.findall(r"\[([\d, ]*)\]", key)
            if len(dims.split(",")) >= 3
            and int(dims.split(",")[-1]) in sizes]


@pytest.mark.parametrize("case", list(CASES))
def test_logits_stay_sharded_by_vocabulary(world, case):
    """The logits come out sharded over "model" on their last dim, and
    the loss's collectives are (rows, S) and the table's, never the
    logits'."""
    got = world[1]["nll"][case]
    assert "Shard(dim=2)" in got["logits_placements"]
    assert not _vocab_sized(got["shapes"], CASES[case][0]), got["shapes"]
    assert any(k.startswith("all-reduce float32") for k in got["shapes"])


def test_odd_vocabulary_family_loss_matches_the_reference(worlds, carried):
    np.testing.assert_allclose(worlds((1, 2, 2))["hubert"]["loss"],
                               carried["ref_loss"], **LOSS_F32)


def test_odd_vocabulary_family_gradients_match(worlds, carried):
    assert_leaves_within_share(worlds((1, 2, 2))["hubert"]["grads"],
                                carried["adam"]["grads"], GRAD_F32_SHARE)


def test_odd_vocabulary_family_steps_match(worlds, carried):
    res = worlds((1, 2, 2))["hubert"]
    assert_steps_match(res, carried["adam"])
    assert res["opt_placements_match"] is True


# arch -> (config fields, sequence)
BF16_STEPS = {"qwen3_0_6b": ({}, 32), "mamba2_1_3b": (ODD, 64)}


@pytest.mark.parametrize("arch", list(BF16_STEPS))
def test_bf16_step_census_moves_no_logits_and_no_f32_partial_sums(arch):
    """A reduced bf16 training step (remat on) over a fake gloo mesh:
    neither the logits nor a float32 residual activation cross it."""
    override, seq = BF16_STEPS[arch]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **override)
    assert cfg.compute_dtype == "bfloat16"
    census = T_cells.CollectiveCensus()
    T_cells.fake_census(cfg, ShapeConfig("tiny_train", seq, 4, "train"),
                        {"pod": 1, "data": 2, "model": 2},
                        T_cells.train_config(), device="cpu", census=census)
    shapes = census.by_shape
    assert census.n_ops > 0
    assert not _vocab_sized(shapes, cfg.vocab_size), shapes
    act = [k for k in shapes if k.startswith("all-reduce float32[")
           and k.endswith(f", {seq}, {cfg.d_model}]")]
    assert not act, act
    assert any(k.startswith("reduce-scatter bfloat16[") and
               k.endswith(f", {seq // 2}, {cfg.d_model}]") for k in shapes), \
        shapes


def test_plain_loss_is_log_softmax_and_gather_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 7, 50, generator=gen)
    targets = torch.randint(0, 50, (3, 7), generator=gen)
    want = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                         targets[..., None])[..., 0]
    assert torch.equal(L.vocab_parallel_nll(logits, targets), want)
    x = torch.randn(3, 7, 16, generator=gen)
    params = {"unembed": torch.randn(16, 50, generator=gen)}
    assert torch.equal(L.unembed(params, None, x, vocab_shards=True),
                       L.unembed(params, None, x))


def test_block_nll_on_one_block_is_the_softmax_gradient():
    """`_BlockNLL` with one block (no reduction): the NLL and its
    gradient, softmax - onehot, as autograd gives them through
    `log_softmax`."""
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 5, 40, generator=gen, dtype=torch.float64)
    targets = torch.randint(0, 40, (2, 5), generator=gen)
    g = torch.rand(2, 5, generator=gen, dtype=torch.float64)
    a = logits.clone().requires_grad_()
    got = L._BlockNLL.apply(a, targets, 0, lambda t, op: t)
    (ga,) = torch.autograd.grad(got, a, g)
    b = logits.clone().requires_grad_()
    want = -torch.gather(F.log_softmax(b, dim=-1), -1,
                         targets[..., None])[..., 0]
    (gb,) = torch.autograd.grad(want, b, g)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ga, gb, rtol=1e-12, atol=1e-12)
