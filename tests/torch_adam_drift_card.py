"""Where the reduced families' training on the card and on the CPU part,
and why: float32 sums, then Adam.  Needs an NVIDIA GPU.

    PYTHONPATH=src python tests/torch_adam_drift_card.py \
        [--arch mamba2_1_3b] [--steps 3]

The reduced config of `--arch` in float32 (compute and parameters), the
same parameters on the CPU and on the card, `make_train_step` with the
optimizer chip_smoke's `lm_train_families_card_vs_cpu` uses (lr 1e-3,
warmup 2) on the data pipeline's 2 x 128 batches, both devices running
free.  Prints one JSON line a step: each parameter leaf's gradient
difference as a share of its largest CPU gradient (both devices'
gradients taken from their own parameters of that step), the largest
parameter difference after the step, and for the element where it
lies both devices' gradients and Adam moments.  A gradient element near
zero whose sums land apart on the two devices is moved by Adam, which
divides it by its own running magnitude, by a large share of the
learning rate.  That drift is why chip_smoke's
`lm_train_families_card_vs_cpu` starts each step on both devices from
the same state and holds the gradients as well (PERF.md).  Not
collected by pytest.
"""
import argparse
import dataclasses
import json
import subprocess
import sys


def _names(tree, prefix=""):
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += _names(tree[key], prefix + key + "/")
        else:
            out.append(prefix + key)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_1_3b")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import lm as lm_mod
    from repro_torch.train import optimizer
    from repro_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(configs.get_config(args.arch, reduced=True),
                              compute_dtype="float32", param_dtype="float32")
    cpu = lm_mod.build_model(cfg, device="cpu",
                             generator=torch.Generator("cpu").manual_seed(0))
    models = {"cpu": cpu, "cuda": lm_mod.build_model(
        cfg, device="cuda", params=lm_mod._tree_map(
            lambda t: t.detach().to("cuda"), cpu.params))}
    names = _names(cpu.params)
    data = pipeline.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                               seq_len=128, global_batch=2,
                               modality=cfg.modality, d_model=cfg.d_model,
                               n_image_tokens=cfg.n_image_tokens)
    tcfg = ts.TrainConfig(opt=optimizer.OptConfig(lr=1e-3, warmup_steps=2))
    state, steps = {}, {}
    for dev, model in models.items():
        steps[dev], _ = ts.make_train_step(model, tcfg)
        state[dev] = ts.init_train_state(model, tcfg)
    for step in range(args.steps):
        grads, moments = {}, {}
        for dev, model in models.items():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     pipeline.make_batch(data, step).items()}
            params = optimizer.tree_leaves(state[dev][0])
            loss, _ = model.train_loss(batch, state[dev][0])
            grads[dev] = [None if g is None else g.detach().cpu()
                          for g in torch.autograd.grad(loss, params,
                                                       allow_unused=True)]
            state[dev] = steps[dev](*state[dev], batch)[:2]
            opt = state[dev][1]
            moments[dev] = {
                key: [t.detach().cpu() for t in optimizer.tree_leaves(
                    opt[key])]
                for key in sorted(opt) if isinstance(opt[key], dict)}
        share = {}
        for name, gc, gg in zip(names, grads["cpu"], grads["cuda"]):
            if gc is not None:
                share[name] = ((gc - gg).abs().max()
                               / gc.abs().max().clamp_min(1e-30)).item()
        worst = (0.0, None, None)
        for i, (a, b) in enumerate(zip(
                optimizer.tree_leaves(state["cpu"][0]),
                optimizer.tree_leaves(state["cuda"][0]))):
            d = (a.detach() - b.detach().cpu()).abs()
            if d.max().item() > worst[0]:
                worst = (d.max().item(), i, int(d.argmax()))
        err, leaf, flat = worst
        element = None
        if leaf is not None:
            def at(t):
                return None if t is None else t.flatten()[flat].item()
            element = {
                "leaf": names[leaf], "index": flat,
                "grad_cpu": at(grads["cpu"][leaf]),
                "grad_card": at(grads["cuda"][leaf]),
                "moments_cpu": {k: at(v[leaf]) for k, v in
                                moments["cpu"].items()},
                "moments_card": {k: at(v[leaf]) for k, v in
                                 moments["cuda"].items()}}
        print(json.dumps({"arch": args.arch, "step": step + 1,
                          "grad_err_share_of_leaf_max": share,
                          "param_max_abs_diff": err,
                          "worst_element": element}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
