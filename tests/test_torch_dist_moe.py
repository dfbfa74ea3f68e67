"""The MoE families trained over a mesh of processes on the CPU (gloo):
the reduced Phi-3.5-MoE (expert parallelism: 4 experts over "model",
2 picks a token) and the reduced Jamba (a period of attention, the
SSD and the MoE), each against the reference's single-device
`train_loss` and the single-process port (`tests/_torch_dist_harness.py`
has the inputs and bounds).  Phi runs over (1, 2, 2), (1, 1, 2) and
(2, 2, 1), Jamba over (1, 2, 2).  Measured errors in brackets:

- loss and the load-balance `aux` against the reference: rtol 1e-5
  [loss 7.1e-8, aux 0];
- gradient leaves against the single-process port: Phi within 1e-5 of
  each leaf's largest magnitude (`GRAD_F32_SHARE`) [1.0e-6]; Jamba,
  whose SSD heads are split over "model", within `GRAD_SSD_SHARE` of it
  [1.5e-5];
- three AdamW steps: losses and gradient norms rtol 1e-5, parameters
  within 1e-4 [1.4e-7, 0, 1.3e-5]; Jamba's gradient norms rtol 1e-3 and parameters within
  1e-3 (`JAMBA_STEPS`) [2.0e-4, 2.1e-4]: its steps move that much with
  float32 rounding alone.  The single-process port with its parameters
  scaled by (1 + 1e-7 N(0, 1)) moves the second step's gradient norm by
  2.6e-4 relative and the parameters by 4.2e-4 (its router's near-tied
  picks among 4 experts, and AdamW's first step, g / |g|); Phi's
  moves 1.1e-5 so, Mamba-2's 7.0e-5 (measured on the CPU);
- a fault at step 3 (on every rank, on rank 1 alone) rolls every rank
  back to the expert-sharded checkpoint, and the run equals the
  uninterrupted one exactly; that checkpoint, written whole by rank 0,
  restores on one device and onto the mesh exactly.

Besides, in one process: `_moe_groups` over blocks of experts, summed,
is the whole MoE, and over blocks of groups its statistics sum to the
whole's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist_harness import (GRAD_F32_SHARE, GRAD_SSD_SHARE, LOSS_F32,
                                 assert_leaves_within_share,
                                 assert_steps_match, config, reference,
                                 run_world, single_process,
                                 train_cli_over_mesh)
from repro_torch.checkpoint import checkpoint as T_ckpt
from repro_torch.models import moe as M
from repro_torch.train.optimizer import tree_leaves

PHI, JAMBA = "phi3_5_moe_42b", "jamba_v0_1_52b"
# (arch, mesh) of each parity run; Jamba's SSD takes two chunks of 64.
CASES = [(PHI, (1, 2, 2)), (JAMBA, (1, 2, 2)), (PHI, (1, 1, 2)),
         (PHI, (2, 2, 1))]
SEQ = {PHI: 64, JAMBA: 128}
GRAD_SHARE = {PHI: GRAD_F32_SHARE, JAMBA: GRAD_SSD_SHARE}
JAMBA_STEPS = dict(norms=dict(rtol=1e-3, atol=0.0),
                   params=dict(rtol=1e-4, atol=1e-3))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """Per arch: the reference's files and loss, and the single-process
    port's run."""
    out = {}
    for arch in (PHI, JAMBA):
        params, batch, files = reference(
            arch, tmp_path_factory.mktemp(f"carried_{arch}"), SEQ[arch])
        out[arch] = {**files, "adam": single_process(params, batch,
                                                     arch=arch)}
    return out


@pytest.fixture(scope="module")
def worlds(carried, tmp_path_factory):
    """Each mesh's world, run once on first use: its parity jobs, and
    on (1, 2, 2) Phi's `train_with_recovery` runs (uninterrupted, a
    fault on every rank, a fault on rank 1) with their checkpoints."""
    done = {}

    def get(shape):
        if shape not in done:
            jobs = [{"name": arch, "kind": "parity", "arch": arch,
                     "params": carried[arch]["params"],
                     "batch": carried[arch]["batch"]}
                    for arch, mesh in CASES if mesh == shape]
            if shape == (1, 2, 2):
                jobs.append({"name": "faults", "kind": "faults",
                             "arch": PHI})
            done[shape] = run_world(
                shape, jobs, carried[PHI], tmp_path_factory.mktemp(
                    "world_" + "x".join(map(str, shape))))
        return done[shape]
    return get


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{'x'.join(map(str, m))}" for a, m in CASES])
def case(request, worlds, carried):
    arch, shape = request.param
    return arch, worlds(shape)[arch], carried[arch]


def test_sharded_loss_and_aux_match_the_reference(case):
    _, res, want = case
    np.testing.assert_allclose(res["loss"], want["ref_loss"], **LOSS_F32)
    np.testing.assert_allclose(res["aux"], want["ref_aux"], **LOSS_F32)
    assert res["aux"] > 0


def test_sharded_gradients_match_the_single_process_port(case):
    arch, res, want = case
    assert_leaves_within_share(res["grads"], want["adam"]["grads"],
                               GRAD_SHARE[arch])


def test_three_sharded_adamw_steps_match(case):
    arch, res, want = case
    assert_steps_match(res, want["adam"],
                       **(JAMBA_STEPS if arch == JAMBA else {}))
    assert res["opt_placements_match"] is True


def test_census_counts_the_expert_collectives(case):
    _, res, _ = case
    census = res["census"]
    assert census["total"] > 0 and census["n_ops"] > 0


@pytest.mark.parametrize("scenario", ["every", "one"])
def test_an_expert_sharded_rollback_is_taken_by_every_rank(worlds,
                                                          scenario):
    """A fault at step 3, on every rank or on rank 1 alone: every rank
    rolls back to the expert-sharded checkpoint at step 2 and reruns
    it, exactly."""
    res = worlds((1, 2, 2))["faults"]
    clean, hit = res["clean"], res[scenario]
    assert clean["restarts"] == 0 and hit["restarts"] == 1
    want = clean["losses"][:3] + clean["losses"][2:]
    np.testing.assert_allclose(hit["losses"], want, rtol=0, atol=0)
    for a, b in zip(hit["params"], clean["params"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_an_expert_sharded_checkpoint_restores_on_one_device(worlds):
    res = worlds((1, 2, 2))["faults"]["clean"]
    step, state = T_ckpt.restore(res["ckpt"])
    assert step == 4 and res["restarts"] == 0
    restored = [torch.as_tensor(x) for x in tree_leaves(state["params"])]
    assert len(restored) == len(res["params"])
    for a, b in zip(restored, res["params"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_an_expert_sharded_checkpoint_restores_onto_the_mesh(worlds):
    res = worlds((1, 2, 2))["faults"]
    placed = res["restored_on_mesh"]
    assert placed["all_dtensors"]
    for a, b in zip(placed["params"], res["clean"]["params"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Expert blocks in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_expert_blocks_sum_to_the_whole_moe(capacity_factor):
    """What each model rank computes: every group routed over all
    experts, only its block's slots computed.  The blocks' outputs sum
    to the whole MoE (with ample capacity and with drops), and each
    block's statistics are the whole's (so one rank alone counts
    them)."""
    cfg = dataclasses.replace(config(PHI), capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(0)
    p = M.moe_init(gen, cfg)
    x = torch.randn((3, 32, cfg.d_model), generator=gen)
    args = (p["router"], p["w_up"], p["w_gate"], p["w_down"])
    whole, me, ce = M._moe_groups(x, *args, cfg=cfg, experts=(0, 4),
                                  n_groups=3)
    parts = [M._moe_groups(x, p["router"], p["w_up"][e0:e1],
                           p["w_gate"][e0:e1], p["w_down"][e0:e1], cfg=cfg,
                           experts=(e0, e1), n_groups=3)
             for e0, e1 in ((0, 2), (2, 4))]
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole,
                               rtol=1e-6, atol=1e-6)
    for i in (1, 2):
        torch.testing.assert_close(parts[0][i], parts[1][i], rtol=0, atol=0)
        torch.testing.assert_close(parts[0][i], (me, ce)[i - 1], rtol=0,
                                   atol=0)


def test_group_blocks_sum_to_the_statistics():
    """What each batch rank computes: its groups' share of the two
    means over all groups; the shares sum to the whole's."""
    cfg = config(PHI)
    gen = torch.Generator().manual_seed(1)
    p = M.moe_init(gen, cfg)
    x = torch.randn((4, 16, cfg.d_model), generator=gen)
    args = (p["router"], p["w_up"], p["w_gate"], p["w_down"])
    whole = M._moe_groups(x, *args, cfg=cfg, experts=(0, 4), n_groups=4)
    parts = [M._moe_groups(x[r], *args, cfg=cfg, experts=(0, 4),
                           n_groups=4) for r in (slice(0, 2), slice(2, 4))]
    torch.testing.assert_close(torch.cat([parts[0][0], parts[1][0]]),
                               whole[0], rtol=0, atol=0)
    for i in (1, 2):
        torch.testing.assert_close(parts[0][i] + parts[1][i], whole[i],
                                   rtol=1e-6, atol=0)


def test_train_cli_trains_jamba_over_a_mesh(tmp_path):
    """`launch.train --mesh` takes the hybrid (attention, the SSD and the MoE): two gloo processes, one
    checkpoint that one device restores."""
    train_cli_over_mesh("jamba_v0_1_52b", tmp_path / "ckpt")
    step, state = T_ckpt.restore(tmp_path / "ckpt")
    assert step == 2 and set(state) == {"params", "opt"}
