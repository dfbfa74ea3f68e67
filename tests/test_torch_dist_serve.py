"""Prefill and decode over a mesh of processes on the CPU (gloo): the
port's `LM.prefill` and `LM.decode_step` on a placed model against the
reference's single-device `prefill` and `decode_step` on the same numpy
inputs, and the serving cells' collective census.

One (1, 2, 2) world runs every job (`tests/_torch_dist_harness.py`,
`tests/_torch_dist_worker.py`'s `serve` and `census_cell`), while this
process computes the reference's side.  Inputs: the reduced config in
float32 with the reference's `LM.init(PRNGKey(0))` parameters carried
over leaf for leaf (an npz each rank loads and places), tokens and
image embeddings from `np.random.default_rng(0)`.  Each case prefills its prompt,
writes the K/V into the first positions of a longer cache, and
decodes 8 steps teacher-forced; the decode positions fall in every
rank's block of the cache's sequence:

- Qwen3, batch 4: the rows over "data", the sequence (16) over
  "model", blocks of 8, prompt 4, positions 4-11;
- Jamba (attention, the SSD and the MoE), batch 1, the long_500k
  layout: the batch replicated, the sequence (12) over ("data",
  "model"), blocks of 3, prompt 2, positions 2-9;
- Llama-3.2-Vision, batch 4 with image embeddings (the cross slots
  recompute their K/V from them each step), as Qwen3.

Bounds (`GRAD_F32_SHARE`, `GRAD_SSD_SHARE` of the harness, as shares of
each tensor's largest magnitude), the largest errors measured on the
CPU in brackets: the prefill's last logits and K/V stacks, each decode
step's logits and the final K/V and SSM caches within 1e-5 [Qwen3
5.2e-7, Llama-Vision 5.1e-7], Jamba's (its SSD heads split over
"model") within 3e-5 [7.2e-7]; each step's greedy token equal.

- The fake mesh's census of the reduced Qwen3 prefill and decode step
  (`cells.fake_census`, as `run_cell` takes it) equals the gloo
  world's census of the same step, kind by kind and in `n_ops`.
- A decode step moves no tensor with the cache's sequence extent, or
  its shard of it, as a dimension, and its census is the same whatever
  block the position falls in.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist_harness import (GRAD_F32_SHARE, GRAD_SSD_SHARE, _flat,
                                 run_world)
from repro.configs import get_config as R_get_config
from repro.models.lm import build_model as R_build
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells as T_cells
from repro_torch.launch.mesh import fake_production_mesh

QWEN, JAMBA, VLM = "qwen3_0_6b", "jamba_v0_1_52b", "llama_3_2_vision_90b"
WORLD = (1, 2, 2)
MESH = {"pod": 1, "data": 2, "model": 2}
STEPS = 8
# arch -> (batch, prompt, cache length)
CASES = {QWEN: (4, 4, 16), JAMBA: (1, 2, 12), VLM: (4, 4, 16)}
SHARE = {QWEN: GRAD_F32_SHARE, JAMBA: GRAD_SSD_SHARE, VLM: GRAD_F32_SHARE}
# The census cells held against gloo: (mode, sequence).
CENSUS = {"prefill": 32, "decode": 32}


@pytest.fixture(autouse=True)
def _no_group():
    yield
    assert not dist.is_initialized()


def _inputs(rcfg, b: int, n: int) -> dict:
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(1, rcfg.vocab_size, (b, n))
           .astype(np.int32)}
    if rcfg.modality == "vision+text":
        out["image_embeds"] = rng.standard_normal(
            (b, rcfg.n_image_tokens, rcfg.d_model)).astype(np.float32)
    return out


def _reference(arch: str, d) -> tuple:
    """The reference's side of `arch`'s case: its files for the world,
    and a function that runs its single-device prefill and decode steps
    (run while the world does)."""
    b, p, s_max = CASES[arch]
    rcfg = dataclasses.replace(R_get_config(arch, reduced=True),
                               compute_dtype="float32",
                               param_dtype="float32")
    rmodel = R_build(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    data = _inputs(rcfg, b, p + STEPS)
    np.savez(d / "params.npz", **_flat(params))
    np.savez(d / "batch.npz", **data)

    def run() -> dict:
        jp = jax.tree.map(jnp.asarray, params)
        img = data.get("image_embeds")
        img = None if img is None else jnp.asarray(img)
        batch = {"tokens": jnp.asarray(data["tokens"][:, :p])}
        if img is not None:
            batch["image_embeds"] = img
        logits, pre = jax.jit(rmodel.prefill)(jp, batch)
        cache = rmodel.init_cache(b, s_max, dtype=jnp.float32)
        attn = [si for si, slot in enumerate(rmodel.slots)
                if slot.kind == "attn"]
        for si, (k, v) in zip(attn, pre["kv"]):
            c = cache[f"slot{si}"]
            c["k"] = c["k"].at[..., :p, :].set(k)
            c["v"] = c["v"].at[..., :p, :].set(v)
        step = jax.jit(rmodel.decode_step)
        steps = []
        for i in range(STEPS):
            tok = jnp.asarray(data["tokens"][:, p + i:p + i + 1])
            out, cache = step(jp, cache, tok, jnp.int32(p + i),
                              image_embeds=img)
            steps.append(np.asarray(out))
        return {"prefill_logits": np.asarray(logits),
                "prefill_kv": [(np.asarray(k), np.asarray(v))
                               for k, v in pre["kv"]],
                "logits": steps,
                "cache": jax.tree.map(np.asarray, cache)}

    return {"params": str(d / "params.npz"), "batch": str(d / "batch.npz")}, \
        run


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the world's results by job name, the reference's by arch)."""
    import threading

    files, runs = {}, {}
    for arch in CASES:
        files[arch], runs[arch] = _reference(
            arch, tmp_path_factory.mktemp(f"serve_{arch}"))
    jobs = [{"name": arch, "kind": "serve", "arch": arch,
             "prompt": CASES[arch][1], "max_seq": CASES[arch][2],
             "steps": STEPS, **files[arch]} for arch in CASES]
    jobs += [{"name": f"census_{mode}", "kind": "census_cell", "arch": QWEN,
              "mode": mode, "seq": seq} for mode, seq in CENSUS.items()]
    got = {}

    def world():
        try:
            got.update(run_world(WORLD, jobs, files[QWEN],
                                 tmp_path_factory.mktemp("serve_world")))
        except AssertionError as e:      # raised again below
            got["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    want = {arch: run() for arch, run in runs.items()}
    thread.join()
    if "error" in got:
        raise got["error"]
    return got, want


def _within(got, want, share):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= share * float(np.abs(want).max()), (err, share)


@pytest.mark.parametrize("arch", list(CASES))
def test_prefill_over_a_mesh_matches_reference(served, arch):
    got, want = served[0][arch], served[1][arch]
    _within(got["prefill_logits"], want["prefill_logits"], SHARE[arch])
    assert got["prefill_ssm"] is None
    assert len(got["prefill_kv"]) == len(want["prefill_kv"])
    for (gk, gv), (wk, wv) in zip(got["prefill_kv"], want["prefill_kv"]):
        _within(gk, wk, SHARE[arch])
        _within(gv, wv, SHARE[arch])


@pytest.mark.parametrize("arch", list(CASES))
def test_prefill_kv_stacks_take_the_decode_cache_layout(served, arch):
    """The stacks come back placed as `cache_specs` places the cache
    (over a prompt the "model" axis divides)."""
    got = served[0][arch]
    cache_pl = [got["cache_placements"][slot]["k"]
                for slot in sorted(got["cache_placements"])
                if "k" in got["cache_placements"][slot]]
    seq = {QWEN: "(Shard(dim=1), Shard(dim=3))",
           VLM: "(Shard(dim=1), Shard(dim=3))",
           JAMBA: "(Shard(dim=3), Shard(dim=3))"}[arch]
    assert set(cache_pl) == {seq}
    if arch != JAMBA:       # Jamba's 2-token prompt: "model" replicates
        assert got["prefill_placements"] == cache_pl


@pytest.mark.parametrize("arch", list(CASES))
def test_decode_steps_over_a_mesh_match_reference(served, arch):
    got, want = served[0][arch], served[1][arch]
    assert len(got["logits"]) == len(want["logits"]) == STEPS
    for g, w in zip(got["logits"], want["logits"]):
        _within(g, w, SHARE[arch])
        np.testing.assert_array_equal(
            torch.argmax(g[:, -1], dim=-1).numpy(),
            np.argmax(w[:, -1], axis=-1))


@pytest.mark.parametrize("arch", list(CASES))
def test_decode_caches_over_a_mesh_match_reference(served, arch):
    got, want = served[0][arch]["cache"], served[1][arch]["cache"]
    assert set(got) == set(want)
    for slot, leaves in want.items():
        assert set(got[slot]) == set(leaves)
        for name, w in leaves.items():
            assert got[slot][name].dtype == torch.float32
            _within(got[slot][name], w, SHARE[arch])


@pytest.mark.parametrize("mode", list(CENSUS))
def test_fake_mesh_serving_census_equals_the_gloo_census(served, mode):
    got = T_cells.fake_census(
        get_config(QWEN, reduced=True),
        ShapeConfig(f"tiny_{mode}", CENSUS[mode], 4, mode), MESH,
        T_cells.train_config(), device="cpu")
    want = served[0][f"census_{mode}"]["collectives"]
    assert want["total"] > 0 and want["n_ops"] > 0
    assert got == want


class _Shapes(T_cells.CollectiveCensus):
    """The census, with the shape of every collective's output."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = self.n_ops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.n_ops != n:
            self.shapes += [tuple(t.shape) for t in
                            T_cells._pytree_leaves(out)
                            if isinstance(t, torch.Tensor)]
        return out


def _decode_census(arch: str, batch: int, seq: int, position: int):
    with fake_production_mesh({"data": 2, "model": 2}, "cpu") as mesh:
        step, cache, tokens, _, img = T_cells.serve_step_inputs(
            get_config(arch, reduced=True),
            ShapeConfig("tiny_decode", seq, batch, "decode"), mesh,
            meta=True)
        with _Shapes() as census:
            step(cache, tokens, position, img)
    return census


@pytest.mark.parametrize("arch,batch,blocks", [(QWEN, 4, 2), (JAMBA, 1, 4)])
def test_no_collective_carries_the_cache_sequence(arch, batch, blocks):
    """The cache's sequence (72) is split over "model" for a batch the
    batch axes divide, over ("data", "model") for one they do not; no
    collective's tensor has 72 or its block as a dimension, and the
    census is the same with the position in the first block and in the
    last."""
    seq = 72
    first = _decode_census(arch, batch, seq, 1)
    last = _decode_census(arch, batch, seq, seq - 1)
    assert first.n_ops > 0 and first.shapes
    for shape in first.shapes + last.shapes:
        assert seq not in shape and seq // blocks not in shape, shape
    assert first.result() == last.result()
