"""The port's dry-run (`launch.cells`, `launch.dryrun`,
`launch.hillclimb`) and step roofline against the reference, on the
CPU.

Held exactly to the reference, called live: `input_specs` shapes and
types of every (arch, shape) cell; the skip rules' reasons of
`run_cell`; `parse_collective_bytes` on tests/test_dryrun.py's HLO;
`VARIANTS`.  Held with float equality: `step_roofline`, its terms,
`bound` and `step_s`, and `model_flops`.

The meta counts are held to a hand count of a reduced dense config,
exactly (see `_hand_count`), to the same step run on the CPU under the
same counter, exactly (the card's gate in chip_smoke's
`dryrun_vs_card`, rehearsed here), and to the reference's depth
extrapolation identity c(n) = c1 + (n - 1)(c2 - c1), exactly.  The CLI
and the hillclimb write their JSON files here without a GPU.
"""
import dataclasses
import json
import math
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as R_get_config
from repro.configs.base import SHAPES as R_SHAPES
from repro.core import tpu_model as R_tpu
from repro.launch import cells as R_cells
from repro.launch import hillclimb as R_hill
from repro.sharding import rules as R_rules
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import arch as T_arch
from repro_torch.core import tpu_model as T_tpu
from repro_torch.launch import cells as T_cells
from repro_torch.launch import dryrun as T_dryrun
from repro_torch.launch import hillclimb as T_hill
from repro_torch.models.lm import build_model
from repro_torch.obs import telemetry as T_obs
from repro_torch.sharding import rules as T_rules
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig

CELLS = [(a, s) for a in ARCH_IDS for s in R_SHAPES]
# tests/test_dryrun.py:57
HLO = """
      %ar = f32[128,256] all-reduce(f32[128,256] %x), replica_groups={}
      %ag = bf16[16,1024] all-gather(bf16[16,512] %y), dimensions={1}
      %a2a = f32[8,8] all-to-all(f32[8,8] %z), dimensions={0}
      %cp = f32[4] collective-permute(f32[4] %w), source_target_pairs={}
      %dot = f32[2,2] dot(f32[2,2] %a, f32[2,2] %b)
    """


@pytest.fixture(autouse=True)
def _tp_mode():
    """run_cell sets the parallelism mode, a module global of both
    packages: every test leaves it "tp"."""
    try:
        yield
    finally:
        T_rules.set_parallelism("tp")
        R_rules.set_parallelism("tp")


def _tiny(remat=True, n_layers=2):
    """A reduced dense config (Qwen3's, f32 compute) for hand counts."""
    return dataclasses.replace(get_config("qwen3_0_6b", reduced=True),
                               n_layers=n_layers, compute_dtype="float32",
                               remat=remat)


# ---------------------------------------------------------------- parity

def test_collective_parser_equals_the_reference():
    extra = HLO + """
      %t = (bf16[64,32], f32[8]) all-reduce(bf16[64,32] %p, f32[8] %q)
      %rs = s8[1024] reduce-scatter(s8[16384] %r), dimensions={0}
    """
    for text in (HLO, extra, ""):
        assert T_cells.parse_collective_bytes(text) == \
            R_cells.parse_collective_bytes(text)
    out = T_cells.parse_collective_bytes(HLO)
    assert out["n_ops"] == 4 and out["all-reduce"] == 128 * 256 * 4 * 2.0
    assert T_cells.DTYPE_BYTES == R_cells.DTYPE_BYTES
    assert T_cells.COLLECTIVE_FACTOR == R_cells.COLLECTIVE_FACTOR


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}['{k}']"))
        return out
    assert tree.device.type == "meta"
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    want = _ref_leaves(R_cells.input_specs(arch, shape))
    got = _port_leaves(T_cells.input_specs(arch, shape))
    assert got == want


def test_skip_reasons_equal_the_reference():
    """Every cell the reference's rules skip is skipped with the same
    reason; every other cell is applicable in both."""
    from repro.configs.base import shape_applicable as R_applicable
    from repro_torch.configs.base import shape_applicable

    skipped = 0
    for arch, shape in CELLS:
        ok, _ = R_applicable(R_get_config(arch), R_SHAPES[shape])
        assert shape_applicable(get_config(arch), SHAPES[shape])[0] == ok
        if ok:
            continue
        skipped += 1
        want = R_cells.run_cell(arch, shape, multi_pod=False)
        got = T_cells.run_cell(arch, shape, multi_pod=False)
        assert (got.ok, got.skip_reason, got.mesh, got.mode) == \
            (want.ok, want.skip_reason, want.mesh, want.mode)
        assert got.memory is None and got.collectives is None
    assert skipped >= 2
    assert "sub-quadratic" in T_cells.run_cell(
        "gemma_7b", "long_500k", multi_pod=False).skip_reason
    assert "encoder-only" in T_cells.run_cell(
        "hubert_xlarge", "decode_32k", multi_pod=False).skip_reason


def test_cell_result_has_the_reference_fields():
    assert [f.name for f in dataclasses.fields(T_cells.CellResult)] == \
        [f.name for f in dataclasses.fields(R_cells.CellResult)]


@pytest.mark.parametrize("args", [(197e12, 819e9, 50e9),
                                  (197e12, 819e9 * 2, 50e9),
                                  (1e12, 3e9, 7e11), (0.0, 0.0, 0.0),
                                  (3.3e15, 2.2e12, 0.0)])
def test_step_roofline_equals_the_reference(args):
    got, want = T_tpu.step_roofline(*args), R_tpu.step_roofline(*args)
    assert (got.compute_s, got.memory_s, got.collective_s, got.bound,
            got.step_s) == (want.compute_s, want.memory_s,
                            want.collective_s, want.bound, want.step_s)
    t = T_tpu.RooflineTerms(1.0, 3.0, 2.0)
    r = R_tpu.RooflineTerms(1.0, 3.0, 2.0)
    assert (t.bound, t.step_s) == (r.bound, r.step_s) == ("memory", 3.0)


def test_model_flops_and_targets():
    for arch in ("kimi_k2_1t", "qwen3_0_6b"):
        n = get_config(arch).n_active_params()
        assert n == R_get_config(arch).n_active_params()
        for train in (True, False):
            assert T_tpu.model_flops(n, 1e6, train) == \
                R_tpu.model_flops(n, 1e6, train)
    h = T_arch.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.ici_bw, h.hbm_bytes, h.vmem_bytes,
            h.mxu_dim) == (989e12, 3.35e12, 450e9, 80e9, 227 * 1024, 64)
    t = T_tpu.step_roofline(989e12, 3.35e12 * 2, 0.0, target=h)
    assert (t.compute_s, t.memory_s, t.bound) == (1.0, 2.0, "memory")


def test_variants_equal_the_reference():
    assert T_hill.VARIANTS == R_hill.VARIANTS


# ---------------------------------------------------------------- counts

def _hand_count(cfg, b, s, mode):
    """FLOPs of one step of a dense LM with a SwiGLU FFN, from its
    structure.  Each matmul x (m, k) @ W (k, n) is 2 m k n; per layer
    and token the projections are q, k, v, o and the three FFN
    matrices, M = 2 (d qd + 2 d kvd + qd d + 3 d f) per token; the
    flash forward is A = 4 B Hq hd pairs (pairs: j <= i, S (S + 1) / 2
    a row block); the unembedding is U = 2 d V per token it runs on.

    - prefill: L (B S M + A) + B U (only the last position's logits).
    - train with remat: each layer's forward runs twice (the forward
      and remat's recompute), its backward is 2x the forward for every
      matmul (dX and dW) and 2.5x for attention: L (4 B S M + 4.5 A),
      less one down projection a layer, Md = 2 f d per token: the
      recompute stops once the last tensor the backward saved is back
      (`torch.utils.checkpoint`'s non-reentrant early stop), and no
      backward op reads the down projection's output, only its input;
      the unembedding sits outside remat and runs on every position:
      forward once and backward twice, 3 B S U.
    - train without remat: L (3 B S M + 3.5 A) + 3 B S U.
    Embedding lookups, norms, RoPE and the optimizer count no FLOPs."""
    d, qd, kvd, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    m = 2 * (d * qd + 2 * d * kvd + qd * d + 3 * d * f)
    a = 4 * b * cfg.n_heads * cfg.head_dim * s * (s + 1) // 2
    u = 2 * d * cfg.vocab_size
    layers = cfg.n_layers
    if mode == "prefill":
        return layers * (b * s * m + a) + b * u
    if cfg.remat:
        return layers * (b * s * (4 * m - 2 * f * d) + 9 * a // 2) \
            + 3 * b * s * u
    return layers * (3 * b * s * m) + layers * 7 * a // 2 + 3 * b * s * u


@pytest.mark.parametrize("mode,remat", [("prefill", True), ("train", True),
                                        ("train", False)])
def test_meta_count_equals_the_hand_count(mode, remat):
    cfg = _tiny(remat=remat)
    shape = ShapeConfig("t", 64, 2, mode)
    count = T_cells.count_step(build_model(cfg, device="meta"), mode,
                               shape)
    assert count.flops == _hand_count(cfg, 2, 64, mode)
    names = set(count.flops_by_op)
    assert "repro_torch.flash_fwd" in names and "aten.mm" in names
    assert ("repro_torch.flash_bwd" in names) == (mode == "train")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_meta_count_equals_the_cpu_step(mode):
    """The card gate of chip_smoke's `dryrun_vs_card` on the CPU: the
    same step on real tensors under the same counter gives the meta
    count exactly, op by op; the step's arguments have the bytes of
    the real parameters, optimizer state and batch."""
    cfg = _tiny()
    shape = ShapeConfig("t", 32, 2, mode)
    meta = T_cells.count_step(build_model(cfg, device="meta"), mode, shape)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    fn, args = T_cells._step_fn(model, mode, shape, TrainConfig(
        opt=OptConfig()), "cpu")
    if mode != "decode":
        args[-1]["tokens"].copy_(torch.randint(1, cfg.vocab_size, (2, 32)))
    else:
        args[1].zero_()
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        out = fn(*args)
    assert T_cells.flops_by_op(fc) == meta.flops_by_op
    assert fc.get_total_flops() == meta.flops
    assert out is not None
    one = {"data": 1, "model": 1}
    mem = T_cells.memory_per_device(model, mode, shape, one, True, meta)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return tree.nbytes if isinstance(tree, torch.Tensor) else 4

    assert mem["argument_size_in_bytes"] == nbytes(args) + (
        0 if mode == "train" else nbytes(model.params))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "jamba_v0_1_52b"])
def test_depth_identity(mode, arch):
    """c(n periods) = c1 + (n - 1)(c2 - c1) for FLOPs and bytes: the
    identity the reference extrapolates by holds exactly on the port's
    count, which runs every period."""
    base = dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype="float32")
    period = len(build_model(base, device="meta").slots)
    shape = ShapeConfig("t", 16, 2, mode)
    counts = {}
    for n in (1, 2, 3):
        cfg = dataclasses.replace(base, n_layers=n * period)
        c = T_cells.count_step(build_model(cfg, device="meta"), mode, shape)
        counts[n] = (c.flops, c.bytes_accessed)
    for i in range(2):
        c1, c2, c3 = (counts[n][i] for n in (1, 2, 3))
        assert c3 == c1 + 2 * (c2 - c1) and c2 > c1


def test_tensor_bytes_counts_a_broadcast_once():
    x = torch.empty((4, 1, 8), device="meta")
    assert T_cells.tensor_bytes(x) == 128
    assert T_cells.tensor_bytes(x.expand(4, 16, 8)) == 128
    assert T_cells.tensor_bytes(torch.empty((3, 5), dtype=torch.bfloat16,
                                            device="meta").t()) == 30


def test_shard_bytes_divides_by_the_named_axes():
    mesh = {"pod": 2, "data": 16, "model": 16}
    t = torch.empty((100, 33, 7), dtype=torch.bfloat16, device="meta")
    P = T_rules.PartitionSpec
    assert T_cells.shard_bytes(t, P(("pod", "data"), "model", None),
                               mesh) == 4 * 3 * 7 * 2
    assert T_cells.shard_bytes(t, P(), mesh) == 100 * 33 * 7 * 2
    assert T_cells.shard_bytes(t, P(None, ("data", "model")),
                               {"data": 16, "model": 16}) == 100 * 1 * 7 * 2
    assert T_cells.shard_bytes(3, P(), mesh) == 4


def test_run_cell_record(monkeypatch):
    """A counted cell: per-device counts (totals over 256), the memory
    keys the port can give (no temp or code size), the collective
    census over a fake "cpu" mesh under the reference's keys, `lower_s`
    (the count) and `compile_s` (the census) from the telemetry
    clock."""
    ticks = iter([10.0, 12.5, 13.0, 16.5])
    prev = T_obs.set_default_clock(lambda: next(ticks))
    monkeypatch.setattr(T_cells, "get_config",
                        lambda a: get_config(a, reduced=True))
    try:
        res = T_cells.run_cell("qwen3_0_6b", "train_4k", multi_pod=False,
                               device="cpu")
    finally:
        T_obs.set_default_clock(prev)
    assert res.ok and res.mesh == "16x16" and res.mode == "train"
    assert res.lower_s == 2.5 and res.compile_s == 3.5
    assert set(res.collectives) == set(T_cells.parse_collective_bytes(""))
    assert res.collectives["total"] > 0 and res.collectives["n_ops"] > 0
    assert set(res.memory) == {"argument_size_in_bytes",
                               "output_size_in_bytes"}
    cfg = get_config("qwen3_0_6b", reduced=True)
    assert res.flops == _hand_count(cfg, 256, 4096, "train") / 256
    assert res.n_params == float(cfg.n_params())
    rec = json.loads(json.dumps(res.to_json()))
    assert rec["collectives"] == res.collectives and rec["ok"]


def test_dryrun_cli_merges_two_cells(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(T_cells, "get_config",
                        lambda a: get_config(a, reduced=True))
    for shape in ("train_4k", "decode_32k"):
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", "qwen3_0_6b", "--shape", shape,
            "--out", str(tmp_path), "--device", "cpu"])
        T_dryrun.main()
    data = json.loads((tmp_path / "dryrun_16x16.json").read_text())
    assert sorted(data) == ["qwen3_0_6b|decode_32k", "qwen3_0_6b|train_4k"]
    assert all(r["ok"] and r["flops"] > 0 for r in data.values())
    assert data["qwen3_0_6b|train_4k"]["collectives"]["total"] > 0
    assert data["qwen3_0_6b|decode_32k"]["collectives"]["total"] > 0
    out = capsys.readouterr().out
    assert "no census" not in out
    for cell in data.values():
        assert f"coll/dev={cell['collectives']['total']:.3e}B" in out
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "gemma_7b", "--shape", "long_500k", "--multi-pod",
        "--out", str(tmp_path)])
    T_dryrun.main()                       # a skip exits 0
    data = json.loads((tmp_path / "dryrun_2x16x16.json").read_text())
    assert "sub-quadratic" in data["gemma_7b|long_500k"]["skip_reason"]
    assert "SKIP" in capsys.readouterr().out


def test_hillclimb_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(T_cells, "get_config",
                        lambda a: get_config(a, reduced=True))
    base = T_hill.run("qwen3_0_6b", "train_4k", "baseline", device="cpu")
    no_remat = T_hill.run("qwen3_0_6b", "train_4k", "no_remat",
                          device="cpu")
    T_hill.run("qwen3_0_6b", "train_4k", "dp_only", device="cpu")
    data = json.loads((tmp_path / "artifacts/perf/qwen3_0_6b_train_4k.json")
                      .read_text())
    assert sorted(data) == ["baseline", "dp_only", "no_remat"]
    assert data["baseline"]["coll"]["total"] > 0
    assert data["baseline"]["collective_s"] == \
        data["baseline"]["coll"]["total"] / T_arch.H100_SXM.ici_bw
    # replicating the model over "model" changes what is sent
    assert data["dp_only"]["coll"] != data["baseline"]["coll"]
    assert no_remat["compute_s"] < base["compute_s"]
    assert base["compute_s"] == base["flops"] / T_arch.H100_SXM.peak_flops
    assert data["dp_only"]["flops"] == base["flops"]
    assert T_rules._PARALLELISM == "dp"


def test_step_counts_on_meta_allocate_nothing():
    """A published config's train step on meta: Qwen3-0.6B train_4k
    counts more FLOPs than 6 N D and stays on the meta device."""
    cfg = get_config("qwen3_0_6b")
    count = T_cells.count_step(build_model(cfg, device="meta"), "train",
                               SHAPES["train_4k"])
    tokens = SHAPES["train_4k"].tokens
    assert count.flops > T_tpu.model_flops(cfg.n_params(), tokens, True)
    leaves = [t for t in jax.tree_util.tree_leaves(
        count.outputs[:2]) if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert math.isfinite(count.bytes_accessed) and np.isscalar(count.flops)
