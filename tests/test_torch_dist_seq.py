"""The residual stream sharded by sequence over "model" between
products (`sharding.rules.ACT_TOKENS_SEQ`), on the CPU.

- Gloo worlds of (1, 1, 2) and (1, 2, 2), a process a rank
  (`tests/_torch_dist_harness.py`, the worker's `stream` job): a hook
  on `repro_torch.models.lm._slot_apply` reads the stream after every
  layer of one training step (remat on: its recompute stops before a
  layer's output) and of a prefill of the reduced Qwen3 in float32,
  drawn from seed 0 on the mesh.  Every layer's output is sharded over
  "model" by sequence, each rank holding 1/2 of the rows' positions;
  the step's loss and the prefill's last logits equal one process's on
  the same draw (loss rtol 1e-5, `LOSS_F32`; logits within 1e-5 of
  their largest, `GRAD_F32_SHARE`).  The 1x1x1 world, which has no "model" axis, is
  held in `tests/test_torch_dist_train.py`.
- The census of a reduced bf16 Qwen3 training step and prefill over a
  fake gloo mesh of (data 2, model 2), its head dim 64 so that the
  attention output (q_dim 256) is wider than the stream (d_model 128),
  as at full width (2048 against 1024): no all-reduce carries a (rows,
  S, d_model) activation, no all-gather the attention output whole;
  the row-parallel partial sums are reduce-scattered to the stream's
  shards and the attention output goes to column shards by an
  all-to-all.
- Decode steps keep their plan: the census of a reduced Qwen3,
  Jamba and Llama-3.2-Vision decode step over the same fake mesh
  equals, kind by kind, the one the stream whole over "model" gave.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from _torch_dist_harness import (GRAD_F32_SHARE, LOSS_F32, config,
                                 run_world)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells as T_cells
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

QWEN = "qwen3_0_6b"
SEQ = 32
WORLDS = {(1, 1, 2): "(Shard(dim=1),)",
          (1, 2, 2): "(Shard(dim=0), Shard(dim=1))"}
MESH = {"pod": 1, "data": 2, "model": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world of `WORLDS`, run once on first use: the `stream` job."""
    done = {}

    def get(shape):
        if shape not in done:
            out = tmp_path_factory.mktemp("world_" + "x".join(map(str, shape)))
            done[shape] = run_world(
                shape, [{"name": "stream", "kind": "stream", "seq": SEQ}],
                {"params": "", "batch": ""}, out)["stream"]
        return done[shape]
    return get


@pytest.fixture(scope="module", params=list(WORLDS),
                ids=["x".join(map(str, m)) for m in WORLDS])
def world(request, worlds):
    return request.param, worlds(request.param)


@pytest.fixture(scope="module")
def one_process():
    """The same prefill and step on one process, from the same draw."""
    cfg = config(QWEN)
    model = LM(cfg, device="cpu",
               generator=torch.Generator("cpu").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, SEQ)).astype(np.int32))
    logits, _ = model.prefill({"tokens": tokens})
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
    step, _ = make_train_step(model, tcfg)
    params, opt_state = init_train_state(model, tcfg)
    _, _, met = step(params, opt_state, {"tokens": tokens})
    return {"loss": met["loss"].item(), "logits": logits}


@pytest.mark.parametrize("path", ["train", "prefill"])
def test_stream_is_sharded_by_sequence_between_layers(world, path):
    shape, res = world
    seen = res[path]
    rows = 4 // shape[1]
    # one output a layer: remat's recompute in the backward stops at the
    # last tensor the backward saved, before a layer's output
    assert seen == [(WORLDS[shape], (rows, SEQ // 2, 128))] \
        * config(QWEN).n_layers


def test_sequence_sharded_step_matches_one_process(world, one_process):
    _, res = world
    np.testing.assert_allclose(res["loss"], one_process["loss"], **LOSS_F32)
    want = one_process["logits"]
    err = (res["logits"] - want).abs().max().item()
    assert err <= GRAD_F32_SHARE * want.abs().max().item(), err


def _shape(key: str) -> tuple:
    dims = re.search(r"\[([\d, ]*)\]", key).group(1)
    return tuple(int(d) for d in dims.split(", ")) if dims else ()


def _census(cfg, mode: str, seq: int) -> T_cells.CollectiveCensus:
    census = T_cells.CollectiveCensus()
    T_cells.fake_census(cfg, ShapeConfig(f"tiny_{mode}", seq, 4, mode), MESH,
                        T_cells.train_config(), device="cpu", census=census)
    return census


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_census_reduces_partial_sums_to_sequence_shards(mode):
    """A bf16 step: the partial sums of `wo` and `w_down` are
    reduce-scattered to (rows, S / 2, d_model), the attention output
    goes to column shards by an all-to-all, and no all-reduce carries
    a (rows, S, d_model) activation nor an all-gather the attention
    output (rows, S, q_dim) whole (a gather's output stacks its
    shards on dim 0, so it is told by its size and last dim)."""
    cfg = dataclasses.replace(get_config(QWEN, reduced=True), head_dim=64)
    assert cfg.compute_dtype == "bfloat16" and cfg.q_dim != cfg.d_model
    rows = 4 // MESH["data"]
    shapes = _census(cfg, mode, SEQ).by_shape
    stream = [k for k in shapes if k.startswith("all-reduce")
              and _shape(k)[-2:] == (SEQ, cfg.d_model)]
    assert not stream, stream
    whole_out = [k for k in shapes if k.startswith("all-gather")
                 and _shape(k)[-1] == cfg.q_dim
                 and np.prod(_shape(k)) == rows * SEQ * cfg.q_dim]
    assert not whole_out, whole_out
    assert f"reduce-scatter bfloat16[{rows}, {SEQ // 2}, {cfg.d_model}]" \
        in shapes, shapes
    assert shapes[f"all-to-all bfloat16[2, {rows}, {SEQ // 2}, "
                  f"{cfg.q_dim // 2}]"][0] == \
        cfg.n_layers * (3 if mode == "train" else 1), shapes


# The decode steps' censuses over `MESH` (a reduced config at 4 x 32,
# position 31) with the stream whole over "model" between products, as
# they were before it was sharded by sequence: bytes by kind, n_ops.
DECODE = {
    QWEN: ({"all-reduce": 15616.0, "all-gather": 232464.0,
            "reduce-scatter": 11264.0}, 61),
    "jamba_v0_1_52b": ({"all-reduce": 28032.0, "all-gather": 252512.0,
                        "reduce-scatter": 19240.0}, 103),
    "llama_3_2_vision_90b": ({"all-reduce": 28032.0, "all-gather": 391696.0,
                              "reduce-scatter": 16896.0}, 101),
}


@pytest.mark.parametrize("arch", list(DECODE))
def test_decode_census_is_unchanged(arch):
    got = _census(get_config(arch, reduced=True), "decode", SEQ).result()
    kinds, n_ops = DECODE[arch]
    want = {k: kinds.get(k, 0.0) for k in T_cells.COLLECTIVE_FACTOR}
    assert {k: got[k] for k in want} == want
    assert got["n_ops"] == n_ops
