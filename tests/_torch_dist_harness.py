"""Shared pieces of the training-mesh tests on the CPU
(`tests/test_torch_dist_*.py`): the reference's inputs and loss, the
single-process port each world is held to, and gloo worlds of
processes, one a rank (`tests/_torch_dist_worker.py`, torch and the
port only), on free localhost ports.

Inputs, as the reference's own multi-device test takes them: a reduced
config in float32 compute and parameters with the reference's
`LM.init(PRNGKey(0))` parameters carried over by
`convert.lm_params_from_numpy`, and a batch of 4 rows from
`np.random.default_rng(0)` (tokens; HuBERT's frames and labels; the
VLM's image embeddings with its tokens).  Bounds:

- the sharded loss and aux against the reference's single-device
  `train_loss`: rtol 1e-5 (`LOSS_F32`);
- each gradient leaf against the port's single-process gradient within
  1e-5 of its largest magnitude (`GRAD_F32_SHARE`, the bound
  tests/test_torch_train.py holds the port to the reference by); with
  the SSD's heads split over "model" (Mamba-2, Jamba) within 3e-5
  (`GRAD_SSD_SHARE`): there the float32 sum order alone moves a
  gradient leaf by about 1e-5 of its largest magnitude.  The
  single-process port is 1.7e-5 (Mamba-2) and 1.6e-5 (Jamba) from the
  reference's `jax.grad` on the same inputs, and splitting the scan's
  heads in one process, its forward bit-equal, moves it by 4.4e-6;
  sharded, 1.0e-5 and 1.5e-5 (measured on the CPU);
- three steps against the single-process port: losses and gradient
  norms rtol 1e-5, parameters within 1e-4 (`PARAMS_F32`).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as R_get_config
from repro.models.lm import build_model as R_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_dist_worker.py")

LOSS_F32 = dict(rtol=1e-5, atol=0.0)
GRAD_F32_SHARE = 1e-5
GRAD_SSD_SHARE = 3e-5
PARAMS_F32 = dict(rtol=1e-4, atol=1e-4)
BATCH = 4


def config(arch: str = "qwen3_0_6b", optimizer: str = "adam",
           override: dict | None = None):
    """The reduced `arch` as the worker builds it: float32 compute and
    parameters, `optimizer`, and the fields of `override` (a job's)."""
    return dataclasses.replace(get_config(arch, reduced=True),
                               compute_dtype="float32",
                               param_dtype="float32", optimizer=optimizer,
                               **(override or {}))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def make_batch(cfg, seq: int) -> dict:
    """`BATCH` rows of the config's inputs from `np.random.default_rng(0)`."""
    rng = np.random.default_rng(0)
    if cfg.modality == "audio":
        return {"frames": rng.standard_normal(
                    (BATCH, seq, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (BATCH, seq)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (BATCH, seq)).astype(np.int32)}
    if cfg.modality == "vision+text":
        batch["image_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def reference(arch: str, d: Path, seq: int = 64,
              override: dict | None = None) -> tuple:
    """The reference's reduced `arch` in float32 with the fields of
    `override`: its `LM.init(PRNGKey(0))` parameters, the batch and its
    single-device loss and aux; the files the worlds read, written
    under `d`.  Returns (params, batch, {"ref_loss", "ref_aux",
    "params", "batch"})."""
    rcfg = dataclasses.replace(R_get_config(arch, reduced=True),
                               compute_dtype="float32",
                               param_dtype="float32", **(override or {}))
    rmodel = R_build(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    batch = make_batch(rcfg, seq)
    ref_loss, met = jax.jit(rmodel.train_loss)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.savez(d / "params.npz", **_flat(params))
    np.savez(d / "batch.npz", **batch)
    return params, batch, {"ref_loss": float(ref_loss),
                           "ref_aux": float(met["aux"]),
                           "params": str(d / "params.npz"),
                           "batch": str(d / "batch.npz")}


def single_process(params: dict, batch: dict, optimizer: str = "adam",
                   arch: str = "qwen3_0_6b", override: dict | None = None,
                   **train) -> dict:
    """The port on one process: loss, aux and gradients at `params`
    (a leaf the loss never reads gets zeros, as under `jax.grad`),
    then three steps on `batch` (what each world is held to);
    `override`: config fields, as `config`'s; `train`: `TrainConfig`
    fields."""
    model = convert.lm_params_from_numpy(config(arch, optimizer, override),
                                         params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = model.train_loss(batch)
    leaves = tree_leaves(model.params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss, aux = loss.detach(), torch.as_tensor(met["aux"]).detach()
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2), **train)
    step, _ = make_train_step(model, tcfg)
    p, o = init_train_state(model, tcfg)
    losses, norms = [], []
    for _ in range(3):
        p, o, m = step(p, o, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return {"loss": loss.item(), "aux": aux.item(),
            "grads": [torch.zeros(x.shape) if g is None else g.detach()
                      for x, g in zip(leaves, grads)],
            "losses": losses, "grad_norms": norms,
            "params": [t.detach().clone() for t in tree_leaves(p)]}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def port_env() -> dict:
    """The environment of a subprocess that imports the port."""
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(ROOT / "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def train_cli_over_mesh(arch: str, ckpt_dir: Path) -> str:
    """`launch.train --mesh 1x1x2 --reduced` for `arch` from torchrun's
    environment (two gloo processes, 2 steps of 2 x 64); its stdout,
    the run held to have ended cleanly with one log line from rank 0."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(free_port()), "-m",
         "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--arch", arch, "--mesh", "1x1x2", "--steps", "2", "--batch", "2",
         "--seq", "64", "--ckpt-dir", str(ckpt_dir)],
        capture_output=True, text=True, env=port_env(), cwd=ROOT,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[train] done: 2 steps, 0 restarts") == 1, r.stdout
    assert "1x1x2 mesh of cpu" in r.stdout
    return r.stdout


def _wait_all(procs, timeout: float) -> list:
    """Exit codes once every process has ended; the rest are killed as
    soon as one fails (they would wait in a collective) or at
    `timeout`."""
    t_end = time.monotonic() + timeout
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            return rcs
        if any(rc not in (None, 0) for rc in rcs) \
                or time.monotonic() > t_end:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return [p.wait() for p in procs]
        time.sleep(0.2)


def run_world(shape, jobs, files: dict, out: Path, timeout=300) -> dict:
    """Run `jobs` in a gloo world of `shape`, a process a rank, on the
    parameters and batch of `files` (`reference`'s) unless a job names
    its own; returns rank 0's results by job name."""
    out.mkdir(parents=True, exist_ok=True)
    n = math.prod(shape)
    spec = {"shape": list(shape), "world_size": n, "jobs": jobs,
            "init_method": f"tcp://localhost:{free_port()}",
            "out": str(out), "params": files["params"],
            "batch": files["batch"]}
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    logs = [open(out / f"rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec_path),
                               str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=port_env(),
                              cwd=ROOT)
             for r in range(n)]
    try:
        rcs = _wait_all(procs, timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = sorted((rc < 0, r) for r, rc in enumerate(rcs) if rc)
    if failed:      # a rank that failed by itself first, not a killed one
        r = failed[0][1]
        raise AssertionError((r, rcs, (out / f"rank{r}.log").read_text()
                              [-3000:]))
    return {job["name"]: torch.load(out / f"{job['name']}.pt",
                                    weights_only=False) for job in jobs}


def assert_leaves_within_share(got, want, share):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g - w).abs().max().item()
        assert err <= share * w.abs().max().item(), (err, w.abs().max())


def assert_steps_match(got, want, norms=LOSS_F32, params=PARAMS_F32):
    """Three steps' losses (rtol 1e-5), gradient norms and parameters
    against `want`'s."""
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_F32)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               **norms)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **params)
