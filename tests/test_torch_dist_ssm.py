"""The SSM family trained over a mesh of processes on the CPU (gloo):
the reduced Mamba-2 (8 SSD heads, two chunks of 64) with its heads
split over "model", against the reference's single-device `train_loss`
and the single-process port (`tests/_torch_dist_harness.py` has the
inputs and bounds), over (1, 2, 2), (1, 1, 2) and (2, 2, 1).  Measured
errors in brackets:

- loss against the reference: rtol 1e-5 [2.1e-7];
- gradient leaves against the single-process port within
  `GRAD_SSD_SHARE` of each leaf's largest magnitude [9.9e-6 over
  (1, 1, 2), 8.6e-6 over (1, 2, 2), 6.5e-7 over (2, 2, 1), where the
  heads are not split];
- three AdamW steps: losses and gradient norms rtol 1e-5, parameters
  within 1e-4 [7.8e-8, 9.4e-7, 2.3e-5];
- a "model" axis that cannot split the heads raises a `ValueError`
  naming both numbers.

Besides, in one process: a block of heads projects onto its own
columns of the whole projection, and the scan of blocks of heads is
the whole scan's columns, bit for bit.
"""
import numpy as np
import pytest
import torch

from _torch_dist_harness import (GRAD_SSD_SHARE, LOSS_F32,
                                 assert_leaves_within_share,
                                 assert_steps_match, config, reference,
                                 run_world, single_process,
                                 train_cli_over_mesh)
from repro_torch.checkpoint import checkpoint as T_ckpt
from repro_torch.models import ssm as S

MAMBA = "mamba2_1_3b"
MESHES = [(1, 2, 2), (1, 1, 2), (2, 2, 1)]
SEQ = 128


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    params, batch, files = reference(MAMBA, tmp_path_factory.mktemp(
        "carried"), SEQ)
    return {**files, "adam": single_process(params, batch, arch=MAMBA)}


@pytest.fixture(scope="module")
def worlds(carried, tmp_path_factory):
    """Each mesh's world, run once on first use: the parity job, and on
    (1, 1, 2) a config of 3 heads (d_inner 384, head dim 128)."""
    done = {}

    def get(shape):
        if shape not in done:
            jobs = [{"name": "adam", "kind": "parity", "arch": MAMBA}]
            if shape == (1, 1, 2):
                jobs.append({"name": "odd", "kind": "heads_split",
                             "arch": MAMBA, "override": {
                                 "ssm_expand": 3, "ssm_head_dim": 128}})
            done[shape] = run_world(shape, jobs, carried,
                                    tmp_path_factory.mktemp(
                                        "world_" + "x".join(map(str, shape))))
        return done[shape]
    return get


@pytest.fixture(scope="module", params=MESHES,
                ids=["x".join(map(str, m)) for m in MESHES])
def world(request, worlds):
    return worlds(request.param)


def test_sharded_loss_matches_the_reference(world, carried):
    np.testing.assert_allclose(world["adam"]["loss"], carried["ref_loss"],
                               **LOSS_F32)
    assert world["adam"]["aux"] == carried["ref_aux"] == 0.0


def test_sharded_gradients_match_the_single_process_port(world, carried):
    assert_leaves_within_share(world["adam"]["grads"],
                               carried["adam"]["grads"], GRAD_SSD_SHARE)


def test_three_sharded_adamw_steps_match(world, carried):
    assert_steps_match(world["adam"], carried["adam"])
    assert world["adam"]["opt_placements_match"] is True


def test_census_counts_collectives(world):
    census = world["adam"]["census"]
    assert census["total"] > 0 and census["n_ops"] > 0


def test_heads_the_model_axis_cannot_split_raise(worlds):
    err = worlds((1, 1, 2))["odd"]["error"]
    assert err is not None
    assert "3 SSD heads do not split over 2 ranks" in err


# ---------------------------------------------------------------------------
# Blocks of heads in one process
# ---------------------------------------------------------------------------

def _ssm(seed=0):
    cfg = config(MAMBA)
    gen = torch.Generator().manual_seed(seed)
    p = S.ssm_init(gen, cfg)
    p["dt_bias"] = 0.1 * torch.randn((cfg.ssm_heads,), generator=gen)
    p["d_skip"] = 1 + 0.1 * torch.randn((cfg.ssm_heads,), generator=gen)
    x = torch.randn((2, SEQ, cfg.d_model), generator=gen)
    return cfg, p, x


def _heads(p, h0, h1):
    return dict(p, **{n: p[n][h0:h1] for n in ("a_log", "dt_bias",
                                               "d_skip")})


@pytest.mark.parametrize("blocks", [2, 4])
def test_a_block_of_heads_projects_onto_its_columns(blocks):
    cfg, p, x = _ssm()
    whole = S._project(p, cfg, x)
    per = cfg.ssm_heads // blocks
    for b in range(blocks):
        h0, h1 = b * per, (b + 1) * per
        part = S._project(_heads(p, h0, h1), cfg, x, (h0, h1))
        cols = slice(h0 * cfg.ssm_head_dim, h1 * cfg.ssm_head_dim)
        for got, want in zip(part, (whole[0][..., cols],
                                    whole[1][..., cols], whole[2],
                                    whole[3], whole[4][..., h0:h1])):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("blocks", [2, 4])
def test_blocks_of_heads_scan_as_the_whole(blocks):
    cfg, p, x = _ssm(1)
    whole = S._ssd_gated(p, cfg, x)
    per = cfg.ssm_heads // blocks
    parts = [S._ssd_gated(_heads(p, b * per, (b + 1) * per), cfg, x,
                          (b * per, (b + 1) * per)) for b in range(blocks)]
    torch.testing.assert_close(torch.cat(parts, dim=-1), whole, rtol=0,
                               atol=0)


def test_check_heads_split_names_both_numbers():
    cfg = config(MAMBA)
    S.check_heads_split(cfg, 4)
    with pytest.raises(ValueError, match="8 SSD heads do not split over 3"):
        S.check_heads_split(cfg, 3)


def test_train_cli_trains_mamba2_over_a_mesh(tmp_path):
    """`launch.train --mesh` takes Mamba-2: two gloo processes, one
    checkpoint that one device restores."""
    train_cli_over_mesh("mamba2_1_3b", tmp_path / "ckpt")
    step, state = T_ckpt.restore(tmp_path / "ckpt")
    assert step == 2 and set(state) == {"params", "opt"}
