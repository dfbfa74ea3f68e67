"""The port's LM training path against the reference, on the CPU.

Inputs: the reduced Qwen3 (2 layers, d 128, vocab 512) with the
reference's `LM.init` parameters carried over by
`convert.lm_params_from_numpy`, and batches from the data pipeline
(seed 0, 4 x 32 tokens).  Tolerances, measured errors in brackets:

- `train_loss` in float32: loss rtol 1e-5 [2.8e-7]; each gradient leaf
  within 1e-5 of its largest magnitude [9.8e-7].  In bfloat16 compute:
  loss within the LM's bfloat16 bounds (rtol 0.05, atol 0.05) [7e-6],
  each gradient leaf within 0.05 of its largest magnitude [0.027].
- `make_train_step`, 3 steps: losses and gradient norms rtol 1e-5
  [3e-7]; parameters within 1e-4 (rtol and atol) [2.5e-5: an early Adam
  step moves a parameter by about lr * sign(g), so a gradient element
  near zero moves it by up to 2 lr = 2e-3 where the two packages' sums
  land on different signs].  With `compress_grads` a gradient element
  on an int8 rounding boundary may take the neighbouring level:
  parameters within 2e-3 [6e-4].  In bfloat16 compute: losses rtol
  1e-3 [8e-5], parameters within 0.05 [3.4e-3].
- Remat on and off: equal gradients, exactly (the same operations run
  again).
- `make_batch`: byte-equal arrays.
- `train_with_recovery`: the reference's three scenarios
  (tests/test_infra.py, the shipped reduced config, so bfloat16
  compute) with equal `steps_run`, `restarts`, `resumed_from` and
  number of losses; losses rtol 1e-3 [2.3e-4 over 12 steps].
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as R_get_config
from repro.data.pipeline import DataConfig as R_DataConfig
from repro.data.pipeline import make_batch as R_make_batch
from repro.models.lm import build_model as R_build
from repro.runtime.fault_tolerance import DriverConfig as R_DriverConfig
from repro.runtime.fault_tolerance import (
    train_with_recovery as R_train_with_recovery)
from repro.train.optimizer import OptConfig as R_OptConfig
from repro.train.train_step import TrainConfig as R_TrainConfig
from repro.train.train_step import make_train_step as R_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as T_ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels.flash_attention import flash_attention as T_fa
from repro_torch.models import layers as T_L
from repro_torch.runtime.fault_tolerance import (DriverConfig,
                                                 train_with_recovery)
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small CPU operations; one intra-op thread
    keeps them fast when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_F32 = dict(rtol=1e-5, atol=0.0)
GRAD_F32_SHARE = 1e-5
LM_BF16 = dict(rtol=0.05, atol=0.05)
GRAD_BF16_SHARE = 0.05
PARAMS_F32 = dict(rtol=1e-4, atol=1e-4)
PARAMS_COMPRESSED = dict(rtol=1e-4, atol=2e-3)
PARAMS_BF16 = dict(rtol=0.05, atol=0.05)
DATA = dict(seed=0, seq_len=32, global_batch=4)


def _configs(compute="float32", **kw):
    ref = dataclasses.replace(R_get_config("qwen3_0_6b", reduced=True),
                              compute_dtype=compute, **kw)
    port = dataclasses.replace(get_config("qwen3_0_6b", reduced=True),
                               compute_dtype=compute, **kw)
    return ref, port


def _models(compute="float32", **kw):
    """(reference LM, its params, port LM with the same params)."""
    rcfg, pcfg = _configs(compute, **kw)
    rmodel = R_build(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(0))
    port = convert.lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return rmodel, params, port


def _batches(vocab, step):
    b = R_make_batch(R_DataConfig(vocab_size=vocab, **DATA), step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_leaves_within_share(port_leaves, ref_leaves, share):
    assert len(port_leaves) == len(ref_leaves)
    for t, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r, np.float32)
        t = t.detach().float().numpy()
        assert t.shape == r.shape
        err = np.abs(t - r).max()
        assert err <= share * np.abs(r).max(), (err, np.abs(r).max())


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_loss_and_gradients(compute):
    rmodel, params, port = _models(compute)
    jb, tb = _batches(rmodel.cfg.vocab_size, 0)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rmodel.train_loss(p, jb), has_aux=True)(params)
    loss, met = port.train_loss(tb)
    grads = torch.autograd.grad(loss, tree_leaves(port.params))
    tol = LOSS_F32 if compute == "float32" else LM_BF16
    np.testing.assert_allclose(loss.item(), float(rloss), **tol)
    np.testing.assert_allclose(met["nll"].item(), float(rmet["nll"]), **tol)
    assert met["aux"] == float(rmet["aux"]) == 0.0
    share = GRAD_F32_SHARE if compute == "float32" else GRAD_BF16_SHARE
    _assert_leaves_within_share(grads, jax.tree.leaves(rgrads), share)


def test_remat_on_and_off_give_equal_gradients():
    grads = {}
    for remat in (True, False):
        _, _, port = _models(remat=remat)
        _, tb = _batches(port.cfg.vocab_size, 1)
        loss, _ = port.train_loss(tb)
        grads[remat] = torch.autograd.grad(loss, tree_leaves(port.params))
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)


def test_remat_runs_each_period_again_in_the_backward():
    """With remat the flash forward runs twice a layer (forward, then
    the recompute in the backward), once without."""
    calls = {}
    for remat in (True, False):
        _, _, port = _models(remat=remat)
        _, tb = _batches(port.cfg.vocab_size, 0)
        before = T_fa.attention.calls
        loss, _ = port.train_loss(tb)
        loss.backward()
        calls[remat] = T_fa.attention.calls - before
    n = get_config("qwen3_0_6b", reduced=True).n_layers
    assert calls == {True: 2 * n, False: n}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "adam": dict(),
    "adafactor": dict(optimizer="adafactor"),
    "microbatches2": dict(microbatches=2),
    "compress_grads": dict(compress_grads=True),
    "adam_bf16": dict(compute="bfloat16"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_three_steps(case):
    kw = dict(STEP_CASES[case])
    compute = kw.pop("compute", "float32")
    mb = kw.pop("microbatches", 1)
    compress = kw.pop("compress_grads", False)
    rmodel, params, port = _models(compute, **kw)
    r_tcfg = R_TrainConfig(opt=R_OptConfig(lr=1e-3, warmup_steps=2),
                           microbatches=mb, compress_grads=compress)
    t_tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2),
                         microbatches=mb, compress_grads=compress)
    r_step, r_init = R_make_train_step(rmodel, r_tcfg)
    r_step = jax.jit(r_step)
    t_step, _ = make_train_step(port, t_tcfg)
    r_opt = r_init(r_tcfg.opt, params)
    t_params, t_opt = init_train_state(port, t_tcfg)
    loss_tol = LOSS_F32 if compute == "float32" else dict(rtol=1e-3,
                                                         atol=0.0)
    for step in range(3):
        jb, tb = _batches(rmodel.cfg.vocab_size, step)
        params, r_opt, rmet = r_step(params, r_opt, jb)
        t_params, t_opt, tmet = t_step(t_params, t_opt, tb)
        np.testing.assert_allclose(tmet["loss"].item(),
                                   float(rmet["loss"]), **loss_tol)
        np.testing.assert_allclose(tmet["grad_norm"].item(),
                                   float(rmet["grad_norm"]), **loss_tol)
    assert int(t_opt["step"]) == int(r_opt["step"]) == 3
    tol = PARAMS_F32
    if compress:
        tol = PARAMS_COMPRESSED
    if compute == "bfloat16":
        tol = PARAMS_BF16
    for t, r in zip(tree_leaves(t_params), jax.tree.leaves(params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), **tol)
    # The optimizer state, leaf for leaf.
    for t, r in zip(tree_leaves(t_opt), jax.tree.leaves(r_opt)):
        assert tuple(t.shape) == tuple(np.shape(r))
    # The model's own parameters are the ones trained (in place).
    assert tree_leaves(port.params)[0] is tree_leaves(t_params)[0]


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modality", ["text", "audio", "vision+text"])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_make_batch_is_byte_equal(modality, n_hosts):
    kw = dict(seed=7, vocab_size=100, seq_len=32, global_batch=8,
              modality=modality, d_model=16, n_image_tokens=3)
    for step in (0, 3):
        for host in range(n_hosts):
            ref = R_make_batch(R_DataConfig(**kw), step, host, n_hosts)
            got = make_batch(DataConfig(**kw), step, host, n_hosts)
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype
                assert got[k].shape == ref[k].shape
                assert got[k].tobytes() == ref[k].tobytes()


def test_make_batch_rejects_an_uneven_host_split():
    with pytest.raises(ValueError):
        make_batch(DataConfig(global_batch=6), 0, 0, 4)


# ---------------------------------------------------------------------------
# The fault-tolerant driver: tests/test_infra.py's three scenarios
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_step():
    """The reference's jitted train step on the reduced Qwen3 and its
    initial state (built once: every scenario starts from it)."""
    cfg = R_get_config("qwen3_0_6b", reduced=True)
    model = R_build(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    tcfg = R_TrainConfig(opt=R_OptConfig(lr=1e-3, warmup_steps=2))
    step, init_opt = R_make_train_step(model, tcfg)
    return jax.jit(step), params, init_opt(tcfg.opt, params)


def _ref_training(reference_step, path, fault_hook=None, total=12):
    step, params, opt = reference_step
    cfg = R_get_config("qwen3_0_6b", reduced=True)
    data = R_DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=4)
    dcfg = R_DriverConfig(total_steps=total, ckpt_every=4,
                          ckpt_dir=str(path), log_every=100)
    return R_train_with_recovery(step, params, opt, data, dcfg,
                                 fault_hook=fault_hook, log=lambda s: None)


def _port_training(path, fault_hook=None, total=12):
    cfg = get_config("qwen3_0_6b", reduced=True)
    rparams, _ = R_build(R_get_config("qwen3_0_6b", reduced=True)).init(
        jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
    train_step, _ = make_train_step(model, tcfg)
    params, opt = init_train_state(model, tcfg)
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=32,
                      global_batch=4)
    dcfg = DriverConfig(total_steps=total, ckpt_every=4,
                        ckpt_dir=str(path), log_every=100)
    return train_with_recovery(train_step, params, opt, data, dcfg,
                               fault_hook=fault_hook, log=lambda s: None)


def _fault_at(step_at):
    fired = {"done": False}

    def fault(step):
        if step == step_at and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("injected node failure")

    return fault, fired


def _assert_reports_equal(port, ref):
    assert (port.steps_run, port.restarts, port.resumed_from) == \
        (ref.steps_run, ref.restarts, ref.resumed_from)
    assert len(port.losses) == len(ref.losses)
    np.testing.assert_allclose(port.losses, ref.losses, rtol=1e-3)


@pytest.mark.parametrize("scenario", ["runs_and_checkpoints",
                                      "recovers_from_injected_fault",
                                      "resumes_from_checkpoint"])
def test_train_with_recovery_scenarios(scenario, tmp_path, reference_step):
    r_dir, t_dir = tmp_path / "ref", tmp_path / "port"
    if scenario == "runs_and_checkpoints":
        _, _, ref = _ref_training(reference_step, r_dir)
        _, _, port = _port_training(t_dir)
        assert T_ckpt.latest_step(t_dir) == 12 == port.steps_run
        assert port.restarts == 0
    elif scenario == "recovers_from_injected_fault":
        r_fault, r_fired = _fault_at(7)
        t_fault, t_fired = _fault_at(7)
        _, _, ref = _ref_training(reference_step, r_dir, r_fault)
        _, _, port = _port_training(t_dir, t_fault)
        assert r_fired["done"] and t_fired["done"]
        assert port.restarts == 1 and port.steps_run == 12
    else:
        _ref_training(reference_step, r_dir, total=8)
        _port_training(t_dir, total=8)
        _, _, ref = _ref_training(reference_step, r_dir, total=12)
        _, _, port = _port_training(t_dir, total=12)
        assert port.resumed_from == 8 and port.steps_run == 12
    _assert_reports_equal(port, ref)


def test_rollback_restores_the_checkpointed_state(tmp_path):
    """After a rollback the retried steps repeat the first pass's
    losses exactly: the parameters and moments were copied back."""
    fault, _ = _fault_at(6)
    _, _, report = _port_training(tmp_path, fault)
    # Steps 0-5 ran, step 6 failed, steps 4-11 ran again from step 4.
    assert report.losses[4:6] == report.losses[6:8]


# ---------------------------------------------------------------------------
# The flash attention inside training goes through the Function
# ---------------------------------------------------------------------------

def test_layers_flash_attention_needing_grad_goes_through_the_function():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 24, 32))
                         .astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 2, 24, 32))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 24, 32))
                         .astype(np.float32))
    before = T_fa.attention.calls
    out = T_L.flash_attention(q, k, v, causal=True)
    assert T_fa.attention.calls == before + 1
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        T_L.flash_attention(q, k, v, causal=True)
    T_L.flash_attention(q.detach(), k, v, causal=True)
    assert T_fa.attention.calls == before + 1
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--reduced", "--steps", "3"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[train] done: 3 steps, 0 restarts" in proc.stdout
    assert T_ckpt.latest_step(tmp_path / "checkpoints") == 3


def test_train_cli_defaults_to_the_card():
    from repro_torch.launch import train

    args = train.parse_args([])
    assert (args.device, args.batch, args.seq, args.arch) == \
        ("cuda", 8, 512, "qwen3_0_6b")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.run(train.parse_args(["--reduced", "--steps", "1"]))
