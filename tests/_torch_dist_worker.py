"""One rank of a gloo training mesh on the CPU, for
`tests/test_torch_dist_*.py` (`tests/_torch_dist_harness.py` starts
the ranks).  It imports torch and the port only
(no jax), so each rank starts quickly.

    python tests/_torch_dist_worker.py SPEC.json RANK

SPEC.json holds the mesh shape, the init method, the world size, the
jobs to run in order and the output directory; rank 0 writes each
job's results there as `<job name>.pt` (whole tensors, `torch.save`).
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import cells
from repro_torch.launch.mesh import close_train_mesh, init_train_mesh
from repro_torch.models.layers import (embedding_specs, unembed,
                                      vocab_parallel_nll)
from repro_torch.models.lm import LM, param_specs
from repro_torch.runtime.fault_tolerance import (DriverConfig,
                                                 train_with_recovery)
from repro_torch.sharding.rules import (ACT_TOKENS, batch_shardable,
                                        batch_spec, distribute,
                                        mesh_placements, set_parallelism)
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step, opt_state_specs,
                                          place_batch, rank_rows)


def whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def config(job: dict):
    """The job's reduced config in float32 compute and parameters, with
    the fields of its `override`."""
    return dataclasses.replace(get_config(job.get("arch", "qwen3_0_6b"),
                                          reduced=True),
                               compute_dtype="float32",
                               param_dtype="float32",
                               optimizer=job.get("optimizer", "adam"),
                               **job.get("override", {}))


def load_params(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(z[key].copy())
    return tree


def load_batch(path: str) -> dict:
    """The batch a job reads: an npz of named arrays (tokens, frames,
    labels, image embeddings), or a .npy of tokens."""
    if path.endswith(".npy"):
        return {"tokens": torch.from_numpy(np.load(path))}
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def local_rows(mesh, batch: dict) -> dict:
    """This rank's rows of every leaf of the global `batch`."""
    rows = slice(*rank_rows(mesh, next(iter(batch.values())).shape[0]))
    return {k: v[rows] for k, v in batch.items()}


def parity(mesh, spec: dict, job: dict) -> dict:
    """Loss and gradients at the carried parameters (the job's own
    files, if it names them, else the spec's), then three steps on the
    same batch; the first step under `CollectiveCensus`."""
    set_parallelism(job.get("parallelism", "tp"))
    cfg = config(job)
    model = LM(cfg, device="cpu",
               params=load_params(job.get("params", spec["params"])),
               mesh=mesh)
    rows = local_rows(mesh, load_batch(job.get("batch", spec["batch"])))
    placed = {k: DTensor.from_local(
        v, mesh, mesh_placements(batch_spec(v.dim() - 1), mesh),
        run_check=False) for k, v in rows.items()}
    leaves = tree_leaves(model.params)
    with implicit_replication():
        loss, metrics = model.train_loss(placed, model.params)
        # A leaf the loss never reads (the audio encoder's token table)
        # has no gradient.
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out = {"loss": whole(loss).item(), "aux": float(whole(metrics["aux"])),
           "grads": [torch.zeros(p.shape) if g is None else
                     whole(g).detach() for p, g in zip(leaves, grads)]}
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2),
                       microbatches=job.get("microbatches", 1),
                       compress_grads=job.get("compress_grads", False))
    step, _ = make_train_step(model, tcfg, mesh)
    params, opt_state = init_train_state(model, tcfg, mesh)
    out["losses"], out["grad_norms"] = [], []
    for i in range(3):
        census = cells.CollectiveCensus()
        with census:
            params, opt_state, met = step(params, opt_state, rows)
        if i == 0:
            out["census"] = census.result()
        out["losses"].append(met["loss"].item())
        out["grad_norms"].append(met["grad_norm"].item())
    out["params"] = [whole(p).detach() for p in tree_leaves(params)]
    out["opt_placements_match"] = all(
        tuple(m.placements) == tuple(p.placements)
        for m, p in zip(tree_leaves(opt_state["m"]), tree_leaves(params))
    ) if "m" in opt_state else None
    set_parallelism("tp")
    return out


def faults(mesh, spec: dict, job: dict) -> dict:
    """`train_with_recovery` over the mesh, 4 steps, a checkpoint every
    2: uninterrupted, then a fault at step 3 on every rank, then on
    rank 1 alone; each run from the same seed."""
    cfg = config(job)
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=32,
                      global_batch=4, modality=cfg.modality,
                      d_model=cfg.d_model,
                      n_image_tokens=cfg.n_image_tokens)
    out = {}
    rank = torch.distributed.get_rank()
    for name, ranks in (("clean", ()), ("every", None), ("one", (1,))):
        fired = []

        def hook(step, ranks=ranks, fired=fired):
            if name != "clean" and step == 3 and not fired:
                fired.append(step)
                if ranks is None or rank in ranks:
                    raise RuntimeError(f"injected fault at {step}")

        model = LM(cfg, device="cpu", mesh=mesh,
                   generator=torch.Generator("cpu").manual_seed(0))
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
        step, _ = make_train_step(model, tcfg, mesh)
        params, opt_state = init_train_state(model, tcfg, mesh)
        ckpt_dir = Path(spec["out"]) / f"ckpt_{name}"
        _, _, report = train_with_recovery(
            step, params, opt_state, data,
            DriverConfig(total_steps=4, ckpt_every=2, ckpt_dir=str(ckpt_dir),
                         log_every=1),
            fault_hook=hook, log=lambda _m: None)
        out[name] = {"losses": report.losses, "restarts": report.restarts,
                     "steps_run": report.steps_run,
                     "ckpt": str(ckpt_dir),
                     "params": [whole(p).detach()
                                for p in tree_leaves(params)]}
    # The clean run's checkpoint placed on the mesh again by the specs.
    specs = param_specs(cfg)

    def on_mesh(tree):
        return {k: on_mesh(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else (mesh, tree)

    _, state = ckpt.restore(out["clean"]["ckpt"], shardings={
        "params": on_mesh(specs),
        "opt": on_mesh(opt_state_specs(specs, cfg.optimizer))})
    placed = tree_leaves(state["params"])
    out["restored_on_mesh"] = {
        "all_dtensors": all(isinstance(x, DTensor) for x in placed),
        "params": [whole(x) for x in placed]}
    return out


def census_cell(mesh, spec: dict, job: dict) -> dict:
    """`cells.measure` over the process mesh at the reduced widths of
    the job's `arch` (Qwen3 by default), 4 rows of its `seq` (32), a
    step of its `mode` ("train" by default; "prefill", "decode"): the
    census of one real step fills the count's `collectives`."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    mode = job.get("mode", "train")
    count, memory = cells.measure(
        get_config(job.get("arch", "qwen3_0_6b"), reduced=True),
        ShapeConfig(f"tiny_{mode}", job.get("seq", 32), 4, mode),
        {a: sizes.get(a, 1) for a in ("pod", "data", "model")},
        process_mesh=mesh)
    return {"collectives": count.collectives, "flops": count.flops,
            "memory": memory}


def heads_split(mesh, spec: dict, job: dict) -> dict:
    """A config whose SSD heads the mesh's "model" axis cannot split
    (the job's `override` of the reduced config): the error's text,
    raised by the training loss where the heads are split."""
    cfg = config(job)
    model = LM(cfg, device="cpu", mesh=mesh,
               generator=torch.Generator("cpu").manual_seed(0))
    rows = local_rows(mesh, {"tokens": torch.zeros((4, 64),
                                                   dtype=torch.int32)})
    placed = {k: DTensor.from_local(
        v, mesh, mesh_placements(batch_spec(1), mesh), run_check=False)
        for k, v in rows.items()}
    try:
        with implicit_replication():
            model.train_loss(placed)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def serve(mesh, spec: dict, job: dict) -> dict:
    """Prefill and decode over the mesh: the job's reduced `arch` in
    float32 with the carried parameters, its batch's `tokens` (B,
    prompt + steps) and image embeddings; this rank's rows placed as
    `cells.serve_step_inputs` places them (the whole batch, replicated,
    where the batch axes do not divide it).  Prefill of the first
    `prompt` tokens; its K/V written into the first `prompt` positions
    of a `max_seq` cache (`LM.init_cache`, float32, zero SSM state);
    then `steps` decode steps teacher-forced at positions prompt,
    prompt + 1, ...  Returns everything whole: the prefill's logits and
    K/V stacks, each step's logits, the final cache, and the
    placements of the prefill's stacks and of the cache."""
    cfg = config(job)
    model = LM(cfg, device="cpu", params=load_params(job["params"]),
               mesh=mesh)
    data = load_batch(job["batch"])
    tokens = data["tokens"]
    b, p = tokens.shape[0], job["prompt"]
    shardable = batch_shardable(mesh, b)
    rows = slice(*rank_rows(mesh, b)) if shardable else slice(None)
    img = {k: v[rows] for k, v in data.items() if k == "image_embeds"}

    def placed(**arrays):
        return place_batch({k: v[rows] for k, v in arrays.items()}, mesh,
                           shardable)

    first = place_batch({"tokens": tokens[rows, :p], **img}, mesh,
                        shardable)
    logits, pre = model.prefill(first)
    out = {"prefill_logits": whole(logits),
           "prefill_kv": [(whole(k), whole(v)) for k, v in pre["kv"]],
           "prefill_ssm": pre["ssm"],
           "prefill_placements": [str(k.placements) for k, _ in pre["kv"]]}
    cache = model.init_cache(b, job["max_seq"], dtype=torch.float32)
    attn = [si for si, slot in enumerate(model.slots) if slot.kind == "attn"]
    for si, kv in zip(attn, pre["kv"]):
        for name, t in zip(("k", "v"), kv):
            leaf = cache[f"slot{si}"][name]
            padded = torch.zeros(leaf.shape)
            padded[..., :p, :] = whole(t)
            leaf.to_local().copy_(distribute_tensor(
                padded, mesh, leaf.placements, src_data_rank=None)
                .to_local())
    out["logits"] = []
    for i in range(job["steps"]):
        step_logits, cache = model.decode_step(
            cache, placed(tokens=tokens[:, p + i:p + i + 1])["tokens"],
            p + i, first.get("image_embeds"))
        out["logits"].append(whole(step_logits))
    out["cache"] = {slot: {n: whole(t) for n, t in leaves.items()}
                    for slot, leaves in cache.items()}
    out["cache_placements"] = {slot: {n: str(t.placements)
                                      for n, t in leaves.items()}
                               for slot, leaves in cache.items()}
    return out


def nll(mesh, spec: dict, job: dict) -> dict:
    """The loss over the vocabulary's shards for each of the job's
    cases, on the inputs of its npz (`<case>/x` (B, S, d), `<case>/w`
    the (d, V) table, `<case>/t` (B, S) targets): x placed by
    `ACT_TOKENS`, the table by `embedding_specs` (columns over "model"
    where 16 divides V, else d_model over ("data", "model")), the
    targets over the batch's rows; `unembed(vocab_shards=True)`'s
    logits, then `vocab_parallel_nll` of the next token (a causal
    case: logits and targets shifted as `LM.train_loss` shifts them)
    or of the target at every position (the encoder's labels).
    Returns per case the mean NLL, the NLL, the gradients of x and the
    table (whole), the logits' placements and the census's shapes."""
    out = {}
    with np.load(job["inputs"]) as z:
        arrays = {k: torch.from_numpy(z[k].copy()) for k in z.files}
    for case in job["cases"]:
        x, w, t = (arrays[f"{case['name']}/{k}"] for k in ("x", "w", "t"))
        table = embedding_specs(types.SimpleNamespace(
            vocab_size=w.shape[1]))["unembed"]
        xd = distribute(x, mesh, ACT_TOKENS).requires_grad_()
        wd = distribute(w, mesh, table).requires_grad_()
        td = distribute(t, mesh, batch_spec(1))
        census = cells.CollectiveCensus()
        with implicit_replication(), census:
            logits = unembed({"unembed": wd}, None, xd, vocab_shards=True)
            if case["causal"]:
                logits, td = logits[:, :-1], td[:, 1:]
            got = vocab_parallel_nll(logits, td)
            loss = got.mean()
            gx, gw = torch.autograd.grad(loss, [xd, wd])
        out[case["name"]] = {
            "loss": whole(loss).item(), "nll": whole(got).detach(),
            "grad_x": whole(gx), "grad_w": whole(gw),
            "logits_placements": str(logits.placements),
            "shapes": census.by_shape}
    return out


def stream(mesh, spec: dict, job: dict) -> dict:
    """The residual stream between layers: the placements and local
    shape of every `_slot_apply` output (a hook on
    `repro_torch.models.lm._slot_apply`) in one training step of the
    job's reduced `arch` (float32, drawn from seed 0 on the mesh, remat
    as the config has it) on 4 x `seq` tokens of seed 0, and in a
    prefill of the same tokens by the model as drawn (the steps update
    their model's parameters).  Returns them with the step's loss, the
    prefill's last logits (whole) and the seconds of the first step
    (DTensor plans every operation), of a second and of the prefill."""
    from repro_torch.models import lm as lm_module
    cfg = config(job)

    def drawn():
        return LM(cfg, device="cpu", mesh=mesh,
                  generator=torch.Generator("cpu").manual_seed(0))

    model = drawn()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, job["seq"])).astype(np.int32))
    seen: list = []
    inner = lm_module._slot_apply

    def hooked(*args, **kwargs):
        x, aux = inner(*args, **kwargs)
        seen.append((str(tuple(x.placements)), tuple(x.to_local().shape)))
        return x, aux

    lm_module._slot_apply = hooked
    try:
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
        step, _ = make_train_step(model, tcfg, mesh)
        params, opt_state = init_train_state(model, tcfg, mesh)
        rows = local_rows(mesh, {"tokens": tokens})
        t0 = time.perf_counter()
        p1, o1, met = step(params, opt_state, rows)
        t1 = time.perf_counter()
        out = {"train": list(seen), "loss": met["loss"].item(),
               "first_step_s": t1 - t0}
        step(p1, o1, rows)
        out["second_step_s"] = time.perf_counter() - t1
        seen.clear()
        model = drawn()
        t0 = time.perf_counter()
        logits, _ = model.prefill(place_batch(rows, mesh, True))
        out.update(prefill=list(seen), logits=whole(logits),
                   prefill_s=time.perf_counter() - t0)
    finally:
        lm_module._slot_apply = inner
    return out


JOBS = {"parity": parity, "faults": faults, "census_cell": census_cell,
        "heads_split": heads_split, "serve": serve, "nll": nll,
        "stream": stream}


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    mesh = init_train_mesh(tuple(spec["shape"]), device="cpu",
                           init_method=spec["init_method"],
                           world_size=spec["world_size"], rank=rank)
    try:
        for job in spec["jobs"]:
            out = JOBS[job["kind"]](mesh, spec, job)
            if rank == 0:
                torch.save(out, Path(spec["out"]) / f"{job['name']}.pt")
    finally:
        close_train_mesh()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
