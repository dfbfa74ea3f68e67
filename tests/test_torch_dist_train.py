"""Training over a mesh of processes on the CPU (gloo): the port's
counterpart of the reference's `tests/test_sharding_multidevice.py::
test_sharded_train_step_matches_single_device`.

Each mesh runs as one gloo world, a process a rank
(`tests/_torch_dist_worker.py`, torch and the port only), on free
localhost ports.  Inputs, as the reference's test takes them: the
reduced Qwen3 (2 layers, d 128, vocab 512) in float32 compute with the
reference's `LM.init(PRNGKey(0))` parameters carried over by
`convert.lm_params_from_numpy`, and 4 x 64 tokens from
`np.random.default_rng(0)`.  The reduced Gemma-7B and Qwen2-7B are
carried over the same way and held on the (1, 2, 2) world by the same
bounds (loss, gradients, three AdamW steps).  Tolerances, measured
errors in brackets:

- the sharded loss against the reference's single-device `train_loss`:
  rtol 1e-5 (`LOSS_F32`) [7e-8];
- each gradient leaf against the port's single-process gradient within
  1e-5 of its largest magnitude (`GRAD_F32_SHARE`, the bound
  `tests/test_torch_train.py` holds the port to the reference by)
  [5e-7];
- three AdamW steps (and Adafactor, AdamW in the "dp" parallelism
  mode, alone and with 4 microbatches, and 2 microbatches) against the single-process port: losses
  and gradient norms rtol 1e-5, parameters within 1e-4 (`PARAMS_F32`)
  [1.2e-5]; with int8 gradient compression the parameters within 2e-3
  (`PARAMS_COMPRESSED`, tests/test_torch_train.py's bound) [6.1e-5];
- a rollback after a fault equals the uninterrupted run exactly (the
  same operations run again on the restored state).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_dist_harness import (GRAD_F32_SHARE, LOSS_F32,
                                 ROOT, assert_leaves_within_share,
                                 assert_steps_match, config, free_port,
                                 port_env, reference, run_world,
                                 single_process)
from repro_torch.checkpoint import checkpoint as T_ckpt
from repro_torch.data.pipeline import DataConfig, make_batch, make_batch_rows
from repro_torch.launch import cells
from repro_torch.launch.mesh import init_train_mesh, parse_mesh
from repro_torch.models.lm import LM
from repro_torch.runtime import faults
from repro_torch.runtime.fault_tolerance import (DriverConfig,
                                                 train_with_recovery)
from repro_torch.sharding.rules import (ACT_Q_ULYSSES, ACT_TOKENS, P,
                                        constrain, placements)
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

PARAMS_COMPRESSED = dict(rtol=1e-4, atol=2e-3)
MESHES = [(2, 2, 2), (1, 4, 1), (1, 1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The other dense families of the slice, each held on the (1, 2, 2)
# world: Gemma-7B (MHA, head dim 64 reduced, GeGLU, the untied head) and
# Qwen2-7B (qkv bias over the sharded columns).
FAMILIES = ["gemma_7b", "qwen2_7b"]


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's parameters and batch, its single-device loss, and
    the single-process port's runs; the files the worlds read.  Under
    each of `FAMILIES`, the same for that family (AdamW only)."""
    params, batch, files = reference("qwen3_0_6b",
                                     tmp_path_factory.mktemp("carried"))
    families = {}
    for arch in FAMILIES:
        a_params, a_batch, families[arch] = reference(
            arch, tmp_path_factory.mktemp(f"carried_{arch}"))
        families[arch]["adam"] = single_process(a_params, a_batch,
                                                 arch=arch)
    return {**files, **families,
            "adam": single_process(params, batch),
            "adafactor": single_process(params, batch, "adafactor"),
            "mb2": single_process(params, batch, microbatches=2),
            "mb4": single_process(params, batch, microbatches=4),
            "compress": single_process(params, batch,
                                       compress_grads=True)}


# Jobs of each world of `MESHES`: the parity job; (1, 1, 2) also runs
# AdamW in the "dp" mode, where the batch takes the "model" axis too,
# alone and with 4 microbatches (2 rows a rank: each microbatch is one
# global row, replicated), with 2 microbatches and with int8 gradient
# compression (one mesh dim keeps DTensor's planning short).
MESH_JOBS = [{"name": "adam", "kind": "parity"}]
JOBS_112 = [{"name": "dp", "kind": "parity", "parallelism": "dp"},
            {"name": "dp_mb4", "kind": "parity", "parallelism": "dp",
             "microbatches": 4},
            {"name": "mb2", "kind": "parity", "microbatches": 2},
            {"name": "compress", "kind": "parity", "compress_grads": True}]


@pytest.fixture(scope="module")
def worlds(carried, tmp_path_factory):
    """Each world of `MESHES`, run once on first use."""
    done = {}

    def get(shape):
        if shape not in done:
            jobs = MESH_JOBS + (JOBS_112 if shape == (1, 1, 2) else [])
            out = tmp_path_factory.mktemp("world_"
                                          + "x".join(map(str, shape)))
            done[shape] = run_world(shape, jobs, carried, out)
        return done[shape]
    return get


@pytest.fixture(scope="module", params=MESHES,
                ids=["x".join(map(str, m)) for m in MESHES])
def world(request, worlds):
    return request.param, worlds(request.param)


@pytest.fixture(scope="module")
def world_122(carried, tmp_path_factory):
    """(1, 2, 2): Adafactor, the faults, a process-mesh census, and the
    other dense families' parity jobs on their own carried inputs."""
    jobs = [{"name": "adafactor", "kind": "parity",
             "optimizer": "adafactor"},
            {"name": "faults", "kind": "faults"},
            {"name": "cell", "kind": "census_cell"}]
    jobs += [{"name": arch, "kind": "parity", "arch": arch,
              "params": carried[arch]["params"],
              "batch": carried[arch]["batch"]} for arch in FAMILIES]
    out = tmp_path_factory.mktemp("world_1x2x2")
    return run_world((1, 2, 2), jobs, carried, out)


@pytest.fixture(scope="module")
def world_111(carried, tmp_path_factory):
    jobs = [{"name": "adam", "kind": "parity"},
            {"name": "cell", "kind": "census_cell"},
            {"name": "stream", "kind": "stream", "seq": 32}]
    out = tmp_path_factory.mktemp("world_1x1x1")
    return run_world((1, 1, 1), jobs, carried, out)


# ---------------------------------------------------------------------------
# The sharded step against the reference and the single-process port
# ---------------------------------------------------------------------------

def test_sharded_loss_matches_the_reference(world, carried):
    _, res = world
    np.testing.assert_allclose(res["adam"]["loss"], carried["ref_loss"],
                               **LOSS_F32)


def test_sharded_gradients_match_the_single_process_port(world, carried):
    _, res = world
    assert_leaves_within_share(res["adam"]["grads"],
                                carried["adam"]["grads"], GRAD_F32_SHARE)


def test_three_sharded_adamw_steps_match(world, carried):
    _, res = world
    assert_steps_match(res["adam"], carried["adam"])
    assert res["adam"]["opt_placements_match"] is True


def test_census_counts_collectives_over_the_mesh(world):
    _, res = world
    census = res["adam"]["census"]
    assert census["total"] > 0 and census["n_ops"] > 0
    assert census["total"] == sum(census[k] for k in cells.COLLECTIVE_FACTOR)


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_dense_family_loss_matches_the_reference(world_122, carried,
                                                       arch):
    np.testing.assert_allclose(world_122[arch]["loss"],
                               carried[arch]["ref_loss"], **LOSS_F32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_dense_family_gradients_match(world_122, carried, arch):
    assert_leaves_within_share(world_122[arch]["grads"],
                                carried[arch]["adam"]["grads"],
                                GRAD_F32_SHARE)


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_dense_family_steps_match(world_122, carried, arch):
    assert_steps_match(world_122[arch], carried[arch]["adam"])
    assert world_122[arch]["opt_placements_match"] is True


def test_three_sharded_adafactor_steps_match(world_122, carried):
    assert_steps_match(world_122["adafactor"], carried["adafactor"])


def test_dp_mode_steps_match(worlds, carried):
    res = worlds((1, 1, 2))["dp"]
    np.testing.assert_allclose(res["loss"], carried["ref_loss"], **LOSS_F32)
    assert_steps_match(res, carried["adam"])


def test_microbatched_steps_match(worlds, carried):
    """Each rank splits its own rows: other microbatches than one
    process's, the same mean."""
    assert_steps_match(worlds((1, 1, 2))["mb2"], carried["mb2"])


def test_microbatches_beyond_a_ranks_rows_match(worlds, carried):
    """More microbatches than a rank's rows: each is the reference's
    slice of the global batch, placed on the mesh dims its rows fill."""
    assert_steps_match(worlds((1, 1, 2))["dp_mb4"], carried["mb4"])


def test_compressed_gradient_steps_match(worlds, carried):
    """The int8 round trip's scale is the whole gradient's maximum on
    every rank; an element on a rounding boundary may take the next
    level, so the parameters are held to `PARAMS_COMPRESSED`."""
    got, want = worlds((1, 1, 2))["compress"], carried["compress"]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_F32)
    for g, w in zip(got["params"], want["params"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   **PARAMS_COMPRESSED)


def test_process_mesh_cell_reads_the_census(world_122, world_111):
    """`cells.measure(..., process_mesh=)`: the census of one real step
    beside the meta count."""
    cell = world_122["cell"]
    assert cell["flops"] > 0 and cell["memory"]
    assert cell["collectives"]["total"] > 0
    none = world_111["cell"]
    assert none["collectives"]["total"] == 0
    assert none["collectives"]["n_ops"] == 0


def test_one_device_mesh_runs_no_collective(world_111, carried):
    res = world_111["adam"]
    assert res["census"]["total"] == 0
    np.testing.assert_allclose(res["loss"], carried["ref_loss"], **LOSS_F32)
    assert_steps_match(res, carried["adam"])


@pytest.mark.parametrize("path", ["train", "prefill"])
def test_one_device_mesh_keeps_the_stream_as_act_tokens(world_111, path):
    """No "model" axis: between layers the residual stream lies as
    `ACT_TOKENS` (the rows over the one "data" dim, the sequence whole),
    as the sequence-sharded spec sanitizes to."""
    seen = world_111["stream"][path]
    assert seen and set(seen) == {("(Shard(dim=0),)", (4, 32, 128))}


# ---------------------------------------------------------------------------
# Faults under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["every", "one"])
def test_rollback_is_taken_by_every_rank(world_122, scenario):
    """A fault at step 3, on every rank or on rank 1 alone: every rank
    rolls back to the sharded checkpoint at step 2 and reruns it."""
    res = world_122["faults"]
    clean, hit = res["clean"], res[scenario]
    assert clean["restarts"] == 0 and hit["restarts"] == 1
    assert hit["steps_run"] == clean["steps_run"] == 4
    want = clean["losses"][:3] + clean["losses"][2:]
    np.testing.assert_allclose(hit["losses"], want, rtol=0, atol=0)
    for a, b in zip(hit["params"], clean["params"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_mesh_checkpoint_restores_on_one_device(world_122):
    res = world_122["faults"]["clean"]
    step, state = T_ckpt.restore(res["ckpt"])
    assert step == 4
    restored = [torch.as_tensor(x) for x in tree_leaves(state["params"])]
    assert len(restored) == len(res["params"])
    for a, b in zip(restored, res["params"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_checkpoint_restores_onto_the_mesh(world_122):
    """`restore(shardings=)` with (training mesh, spec) pairs: each leaf
    a DTensor again, whole as it was written."""
    res = world_122["faults"]
    placed = res["restored_on_mesh"]
    assert placed["all_dtensors"]
    for a, b in zip(placed["params"], res["clean"]["params"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_collective_fault_is_fatal(tmp_path):
    """`DistError` is never retried: the driver raises it at once."""
    err = torch.distributed.DistBackendError("peer gone")
    assert faults.classify(err) == faults.FATAL
    model = LM(config(), device="cpu",
               generator=torch.Generator("cpu").manual_seed(0))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
    step, _ = make_train_step(model, tcfg)
    params, opt_state = init_train_state(model, tcfg)

    def hook(s):
        if s == 1:
            raise err

    with pytest.raises(torch.distributed.DistBackendError):
        train_with_recovery(
            step, params, opt_state,
            DataConfig(seed=0, vocab_size=512, seq_len=16, global_batch=2),
            DriverConfig(total_steps=3, ckpt_every=1,
                         ckpt_dir=str(tmp_path)),
            fault_hook=hook, log=lambda _m: None)


def test_train_cli_under_torchrun(tmp_path):
    """`launch.train --mesh` from torchrun's environment: two gloo
    processes, one log, one checkpoint that one device restores."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(free_port()), "-m",
         "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--mesh", "1x1x2", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=port_env(), cwd=ROOT,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[train] done: 2 steps, 0 restarts") == 1, r.stdout
    assert "1x1x2 mesh of cpu" in r.stdout
    step, state = T_ckpt.restore(tmp_path / "ckpt")
    assert step == 2 and set(state) == {"params", "opt"}


# ---------------------------------------------------------------------------
# Pieces that need no world
# ---------------------------------------------------------------------------

MESH3 = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))


def test_placements_follow_the_spec():
    S, R = torch.distributed.tensor.Shard, torch.distributed.tensor.Replicate
    assert placements(P(("pod", "data"), None, "model", None), MESH3) \
        == (S(0), S(0), S(2))
    assert placements(P("data", "model"), MESH3) == (R(), S(0), S(1))
    assert placements(P(None, ("data", "model")), MESH3) == (R(), S(1), S(1))
    assert placements(P(), MESH3) == (R(), R(), R())
    with pytest.raises(ValueError, match="axis order"):
        placements(P(("model", "data")), MESH3)
    with pytest.raises(ValueError, match="twice"):
        placements(P("data", "data"), MESH3)


def test_constrain_returns_a_plain_tensor_unchanged():
    x = torch.ones(2, 4, 8, 16)
    assert constrain(x, ACT_Q_ULYSSES) is x
    assert constrain(x[0], ACT_TOKENS) is not x


def test_parse_mesh():
    assert parse_mesh("1x2x2") == (1, 2, 2)
    for bad in ("2x2", "1x0x2", "axbxc"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


def test_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a card"):
        init_train_mesh((1, 1, 1), device="cuda",
                        init_method="tcp://localhost:1", world_size=1,
                        rank=0)
    assert not torch.distributed.is_initialized()


def test_batch_rows_are_rows_of_the_one_host_batch():
    cfg = DataConfig(seed=3, vocab_size=512, seq_len=16, global_batch=8)
    whole = make_batch(cfg, 5)
    for start, stop in ((0, 4), (4, 8), (2, 4)):
        rows = make_batch_rows(cfg, 5, start, stop)
        np.testing.assert_array_equal(rows["tokens"],
                                      whole["tokens"][start:stop])


_A2A_SCRIPT = """
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.cells import CollectiveCensus
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
group = funcol._group_or_group_name(funcol._resolve_group((mesh, 0)))
with CollectiveCensus() as census:
    out = torch.ops._dtensor.shard_dim_alltoall(torch.ones(4, 6), 0, 1,
                                                group)
print(census.result()["all-to-all"], out.numel() * out.element_size())
"""


def test_census_counts_dtensors_nccl_all_to_all():
    """On NCCL DTensor moves a shard between tensor dims with its own
    op, `_dtensor.shard_dim_alltoall` (gloo has no all-to-all, so the
    gloo worlds never reach it): run it on a fake process group, in a
    process of its own."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", _A2A_SCRIPT],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    counted, moved = r.stdout.split()[-2:]
    assert float(counted) == float(moved) > 0


def test_census_counts_nothing_without_collectives():
    with cells.CollectiveCensus() as census:
        torch.ones(4) @ torch.ones(4)
    assert census.result()["total"] == 0 and census.result()["n_ops"] == 0
