"""The dry-run's collective census over a fake production mesh
(`launch.mesh.fake_production_mesh`, `launch.cells.fake_census`), on
the CPU with `device="cpu"` (gloo's plans).

- The fake mesh's census of one reduced training step (`fake_census`,
  as `run_cell` takes it) equals, kind by kind and in `n_ops`, the
  census of the same step over real gloo ranks of the same (1, 2, 2)
  world (`tests/_torch_dist_harness.py`, the worker's `census_cell`
  job), for the reduced Qwen3, Phi-3.5-MoE and Mamba-2.  Both sides are "cpu" meshes, so both do every
  all-to-all DTensor plans as an all-gather; the attention output's
  all-to-all to column shards is the port's own
  (`layers._rows_to_columns`) and one on both.
- `run_cell` fills a train cell's census under `parse_collective_bytes`'
  keys and leaves no process group behind, whether its census returned
  or raised; it raises a ValueError in a process already in a group.
- The optimizers' step count lives on the parameters' local shards'
  device: meta on a fake mesh, and one meta step completes.
- Prefill and decode cells take a census the same way (Qwen3's
  prefill_32k and decode_32k, Mamba-2's long_500k), and a decode
  cell's is below its cache's bytes a device.
- The hillclimb's collective term is the census over the H100's link
  bandwidth, and a variant with more microbatches than a rank's rows
  counts.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from _torch_dist_harness import run_world
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.arch import H100_SXM
from repro_torch.core.tpu_model import step_roofline
from repro_torch.launch import cells as T_cells
from repro_torch.launch import hillclimb as T_hill
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.models.lm import LM
from repro_torch.sharding import rules as T_rules
from repro_torch.train.optimizer import OptConfig, adam_init
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

# The reduced families held against gloo, each with the sequence its
# config takes (Mamba-2's SSD scans chunks of 64).
FAMILIES = {"qwen3_0_6b": 32, "phi3_5_moe_42b": 32, "mamba2_1_3b": 64}
WORLD = (1, 2, 2)
MESH = {"pod": 1, "data": 2, "model": 2}
KEYS = set(T_cells.parse_collective_bytes(""))


@pytest.fixture(autouse=True)
def _tp_and_no_group():
    """Every test leaves the parallelism mode "tp" and no process
    group up."""
    try:
        yield
    finally:
        T_rules.set_parallelism("tp")
    assert not dist.is_initialized()


@pytest.fixture
def reduced(monkeypatch):
    """`run_cell` on the reduced configs."""
    monkeypatch.setattr(T_cells, "get_config",
                        lambda a: get_config(a, reduced=True))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The census of each family's step over a gloo world of WORLD."""
    jobs = [{"name": arch, "kind": "census_cell", "arch": arch, "seq": seq}
            for arch, seq in FAMILIES.items()]
    out = tmp_path_factory.mktemp("census_world")
    return run_world(WORLD, jobs, {"params": "", "batch": ""}, out)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_fake_mesh_census_equals_the_gloo_census(gloo, arch):
    got = T_cells.fake_census(
        get_config(arch, reduced=True),
        ShapeConfig("tiny_train", FAMILIES[arch], 4, "train"), MESH,
        T_cells.train_config(), device="cpu")
    want = gloo[arch]["collectives"]
    assert want["total"] > 0 and want["n_ops"] > 0
    assert got == want


def test_run_cell_fills_a_train_cells_census(reduced):
    census = T_cells.CollectiveCensus()
    res = T_cells.run_cell("qwen3_0_6b", "train_4k", multi_pod=False,
                           device="cpu", census=census)
    assert res.ok and res.error == "" and res.mesh == "16x16"
    assert set(res.collectives) == KEYS
    assert res.collectives["total"] > 0 and res.collectives["n_ops"] > 0
    assert res.collectives["total"] == sum(
        res.collectives[k] for k in T_cells.COLLECTIVE_FACTOR)
    # gloo's plans: DTensor's all-to-alls (Ulysses' q) are gathers
    # there; the only all-to-all is the port's own, of the attention
    # output (16 rows a rank, 4096 positions, q_dim 128) from sequence
    # to column shards over the 16 "model" ranks
    a2a = {k for k in census.by_shape if k.startswith("all-to-all")}
    assert a2a == {"all-to-all bfloat16[16, 16, 256, 8]"}
    assert res.collectives["all-to-all"] == sum(
        census.by_shape[k][1] for k in a2a)
    assert res.compile_s > 0 and res.lower_s > 0
    assert not dist.is_initialized()


def test_a_census_that_raises_fails_the_cell(reduced, monkeypatch):
    def broken(*args, **kwargs):
        assert dist.is_initialized()
        raise RuntimeError("planted census fault")

    monkeypatch.setattr(T_cells, "census_train_step", broken)
    res = T_cells.run_cell("qwen3_0_6b", "train_4k", multi_pod=False,
                           device="cpu")
    assert not res.ok and res.collectives is None
    assert "planted census fault" in res.error
    assert not dist.is_initialized()


def test_run_cell_in_a_process_group_raises(reduced):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        with pytest.raises(ValueError, match="already up"):
            T_cells.run_cell("qwen3_0_6b", "train_4k", multi_pod=False,
                             device="cpu")
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_a_cuda_fake_mesh_needs_a_cuda_build():
    if torch.version.cuda is not None:
        pytest.skip("this torch is built with CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with fake_production_mesh(MESH, "cuda"):
            pass
    assert not dist.is_initialized()


def test_fake_mesh_leaves_size_one_axes_out():
    with fake_production_mesh({"pod": 2, "data": 1, "model": 4},
                              "cpu") as mesh:
        assert dist.get_world_size() == 8 and dist.get_rank() == 0
        assert mesh.mesh_dim_names == ("pod", "model")
        assert tuple(mesh.shape) == (2, 4)
    assert not dist.is_initialized()


def test_even_placements_replicate_what_a_mesh_dim_does_not_divide():
    rows = (Shard(0), Shard(0))
    with fake_production_mesh({"data": 4, "model": 4}, "cpu") as mesh:
        assert T_rules.even_placements(rows, (16, 8), mesh) == rows
        assert T_rules.even_placements(rows, (8, 8), mesh) == (
            Shard(0), Replicate())
        assert T_rules.even_placements(rows, (2, 8), mesh) == (
            Replicate(), Replicate())
        assert T_rules.even_placements((Shard(0), Shard(1)), (6, 8),
                                       mesh) == (Replicate(), Shard(1))


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_step_count_lives_on_the_local_shards_device(optimizer):
    cfg = dataclasses.replace(get_config("qwen3_0_6b", reduced=True),
                              optimizer=optimizer)
    tcfg = TrainConfig(opt=OptConfig())
    with fake_production_mesh({"data": 2, "model": 2}, "cpu") as mesh:
        model = LM(cfg, device="meta")
        step, _ = make_train_step(model, tcfg, mesh)
        params, opt_state = init_train_state(model, tcfg, mesh)
        assert opt_state["step"].device.type == "meta"
        batch = T_cells.batch_struct(
            cfg, ShapeConfig("tiny", 32, 2, "train"), "meta")
        params, opt_state, metrics = step(params, opt_state, batch)
        assert opt_state["step"].device.type == "meta"
        assert metrics["loss"].shape == ()
    # On one device the count stays with the parameters.
    one = adam_init(OptConfig(), LM(cfg, device="cpu").params)
    assert one["step"].device == torch.device("cpu")


@pytest.mark.parametrize("arch,shape,widths", [
    ("qwen3_0_6b", "prefill_32k", "reduced"),
    ("qwen3_0_6b", "decode_32k", "reduced"),
    ("mamba2_1_3b", "long_500k", "full")],
    ids=["prefill_32k", "decode_32k", "mamba2_long_500k"])
def test_prefill_and_decode_cells_keep_no_census(monkeypatch, arch, shape,
                                                 widths):
    """Named for what these cells had before their steps ran over a
    mesh: now each takes its census over the fake production mesh as
    a train cell does, and leaves no process group behind.  Mamba-2 at
    its full widths (meta tensors: seconds), whose 64 SSD heads split
    over "model"'s 16 ranks (the reduced config's 8 do not)."""
    if widths == "reduced":
        monkeypatch.setattr(T_cells, "get_config",
                            lambda a: get_config(a, reduced=True))
    res = T_cells.run_cell(arch, shape, multi_pod=False, device="cpu")
    assert res.ok and res.error == "" and res.mode == SHAPES[shape].mode
    assert set(res.collectives) == KEYS
    assert res.collectives["total"] > 0 and res.collectives["n_ops"] > 0
    assert res.compile_s > 0
    if res.mode == "decode":
        assert res.collectives["total"] < T_cells.cache_bytes(
            T_cells.get_config(arch), SHAPES[shape], {"data": 16,
                                                      "model": 16})
    assert not dist.is_initialized()


def test_hillclimb_collective_term_is_the_census(reduced, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    rec = T_hill.run("qwen3_0_6b", "train_4k", "baseline", device="cpu")
    coll = rec["coll"]
    assert set(coll) == KEYS and coll["total"] > 0
    want = step_roofline(rec["flops"], rec["bytes"], coll["total"],
                         target=H100_SXM)
    assert rec["collective_s"] == want.collective_s > 0
    assert rec["step_s"] == want.step_s and rec["bound"] == want.bound


def test_hillclimb_counts_more_microbatches_than_a_ranks_rows(
        reduced, tmp_path, monkeypatch):
    """"dp" leaves each of the 256 ranks 1 row of train_4k's 256; its 4
    microbatches are the reference's slices of the global batch."""
    monkeypatch.chdir(tmp_path)
    rec = T_hill.run("qwen3_0_6b", "train_4k", "dp_mb4", device="cpu")
    assert rec["coll"]["total"] > 0 and rec["collective_s"] > 0
