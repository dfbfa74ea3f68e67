"""The vision-language model and the audio encoder trained over a mesh
of processes on the CPU (gloo), over (1, 2, 2): the reduced
Llama-3.2-Vision (a period of two self-attention layers and one
cross-attention layer whose keys and values come from 16 image
embeddings a row, placed over the batch axes with the tokens) and the
reduced HuBERT-XLarge (frames and labels over the batch axes, full
attention on Ulysses shards, the token table never read), each against
the reference's single-device `train_loss` and the single-process port
(`tests/_torch_dist_harness.py` has the inputs and bounds).  Measured
errors in brackets:

- loss against the reference: rtol 1e-5 [VLM 0, HuBERT 3.6e-7];
- gradient leaves against the single-process port within 1e-5 of each
  leaf's largest magnitude (`GRAD_F32_SHARE`) [1.1e-6, 8.6e-7];
- three AdamW steps: losses and gradient norms rtol 1e-5, parameters
  within 1e-4 [8.6e-8, 8.7e-8, 9.8e-6].
"""
import numpy as np
import pytest
import torch

from _torch_dist_harness import (GRAD_F32_SHARE, LOSS_F32,
                                 assert_leaves_within_share,
                                 assert_steps_match, config, reference,
                                 run_world, single_process,
                                 train_cli_over_mesh)
from repro_torch.checkpoint import checkpoint as T_ckpt
from repro_torch.models.lm import abstract_params
from repro_torch.train.optimizer import tree_leaves

ARCHS = ["llama_3_2_vision_90b", "hubert_xlarge"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    out = {}
    for arch in ARCHS:
        params, batch, files = reference(
            arch, tmp_path_factory.mktemp(f"carried_{arch}"))
        out[arch] = {**files, "adam": single_process(params, batch,
                                                     arch=arch)}
    return out


@pytest.fixture(scope="module")
def world(carried, tmp_path_factory):
    jobs = [{"name": arch, "kind": "parity", "arch": arch,
             "params": carried[arch]["params"],
             "batch": carried[arch]["batch"]} for arch in ARCHS]
    return run_world((1, 2, 2), jobs, carried[ARCHS[0]],
                     tmp_path_factory.mktemp("world_1x2x2"))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_the_reference(world, carried, arch):
    np.testing.assert_allclose(world[arch]["loss"], carried[arch]["ref_loss"],
                               **LOSS_F32)
    assert world[arch]["aux"] == carried[arch]["ref_aux"] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_the_single_process_port(world, carried,
                                                         arch):
    assert_leaves_within_share(world[arch]["grads"],
                               carried[arch]["adam"]["grads"],
                               GRAD_F32_SHARE)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_sharded_adamw_steps_match(world, carried, arch):
    assert_steps_match(world[arch], carried[arch]["adam"])
    assert world[arch]["opt_placements_match"] is True


@pytest.mark.parametrize("arch", ARCHS)
def test_census_counts_collectives(world, arch):
    census = world[arch]["census"]
    assert census["total"] > 0 and census["n_ops"] > 0


def test_the_encoders_unread_token_table_gets_a_zero_gradient(world):
    """HuBERT's front end is a stub: the loss never reads the token
    table, whose gradient is zero on the mesh as under `jax.grad`;
    every other leaf's is not."""
    tree = abstract_params(config("hubert_xlarge"))
    tree["embed"]["tok"] = "tok"
    tok = tree_leaves(tree).index("tok")
    grads = world["hubert_xlarge"]["grads"]
    assert float(grads[tok].abs().sum()) == 0.0
    assert all(float(g.abs().sum()) > 0 for i, g in enumerate(grads)
               if i != tok)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_over_a_mesh(arch, tmp_path):
    """`launch.train --mesh` takes the VLM (its image embeddings) and
    the encoder (frames and labels), each rank its rows of the
    pipeline's batch: two gloo processes, one checkpoint that one
    device restores."""
    train_cli_over_mesh(arch, tmp_path / "ckpt")
    step, state = T_ckpt.restore(tmp_path / "ckpt")
    assert step == 2 and set(state) == {"params", "opt"}
