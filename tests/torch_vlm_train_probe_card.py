"""Where the Llama-3.2-Vision period's loss goes over its first training
steps at full width, and why.  Needs an NVIDIA GPU.

    PYTHONPATH=src python tests/torch_vlm_train_probe_card.py \
        [--steps 4] [--runs shipped,fixed,...]

Each run starts from the same seed-0 parameters of one period (5 of 100
layers) at the config's published widths and takes `--steps` steps of
`make_train_step` on the config's Adafactor at chip_smoke's learning
rate (3e-4, warmup 20, times the run's factor), bf16 compute, on the
data pipeline's 512-token batches.  One JSON line a step: the step's
loss on its batch, the loss of the parameters after the step on batch
0, and the step's learning rate.  Runs:

- `shipped`: bf16 parameters, batch 8, batches 0, 1, 2, ... (what
  chip_smoke's `lm_train_llama_3_2_vision_90b` runs);
- `fixed`: the same on batch 0 at every step, and `fixed_lr0.3`,
  `fixed_lr0.1` at 0.3 and 0.1 times the learning rate;
- `bf16_b2`, `f32_b2`, `f32_b2_lr0.1`: batch 2, bf16 against float32
  parameters (float32 parameters and their gradients do not fit the
  card at batch 8), the last at a tenth of the learning rate;
- `f32_b1_fixed`: float32 parameters, batch 1, batch 0 at every step.

The allocator runs with expandable segments, which leaves less of the
card unusable between float32 parameters' large temporaries.

After `shipped`'s first step, per parameter leaf, on a fixed sample of
up to 2**20 elements: the share that changed and the largest and RMS
change over the learning rate.  Not collected by pytest.
"""
import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys

RUNS = (("shipped", "bfloat16", 8, False, 1.0),
        ("fixed", "bfloat16", 8, True, 1.0),
        ("fixed_lr0.3", "bfloat16", 8, True, 0.3),
        ("fixed_lr0.1", "bfloat16", 8, True, 0.1),
        ("bf16_b2", "bfloat16", 2, False, 1.0),
        ("f32_b2", "float32", 2, False, 1.0),
        ("f32_b2_lr0.1", "float32", 2, False, 0.1),
        ("f32_b1_fixed", "float32", 1, True, 1.0))
SAMPLE = 1 << 20


def _names(tree, prefix=""):
    return [n for k in sorted(tree) for n in (
        _names(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict)
        else [prefix + k])]


def main(argv=None) -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", default=",".join(r[0] for r in RUNS))
    args = ap.parse_args(argv)
    chosen = args.runs.split(",")
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import lm as lm_mod
    from repro_torch.train import optimizer
    from repro_torch.train import train_step as ts

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    full = configs.get_config("llama_3_2_vision_90b")
    for run, pdt, batch, fixed, lr_scale in RUNS:
        if run not in chosen:
            continue
        cfg = dataclasses.replace(full, n_layers=5, param_dtype=pdt)
        torch.cuda.reset_peak_memory_stats()
        try:
            model = lm_mod.build_model(
                cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
            tcfg = ts.TrainConfig(opt=optimizer.OptConfig(
                lr=3e-4 * lr_scale, warmup_steps=20))
            step_fn, init_opt = ts.make_train_step(model, tcfg)
            params = model.params
            opt = init_opt(tcfg.opt, params)
            data = pipeline.DataConfig(
                seed=0, vocab_size=cfg.vocab_size, seq_len=512,
                global_batch=batch, modality=cfg.modality,
                d_model=cfg.d_model, n_image_tokens=cfg.n_image_tokens)

            def batch_of(step):
                return {k: torch.from_numpy(v).to("cuda") for k, v in
                        pipeline.make_batch(data, step).items()}

            with torch.no_grad():
                loss0 = float(model.train_loss(batch_of(0), params)[0])
            print(json.dumps({"run": run, "param_dtype": pdt,
                              "batch": batch, "step": 0,
                              "loss_on_batch0": loss0}), flush=True)
            leaves = optimizer.tree_leaves(params)
            gen = torch.Generator(device="cuda").manual_seed(1)
            picks = [torch.randint(p.numel(), (min(p.numel(), SAMPLE),),
                                   generator=gen, device="cuda")
                     for p in leaves]
            for step in range(args.steps):
                before = [p.detach().flatten()[i].float()
                          for p, i in zip(leaves, picks)]
                b = batch_of(0 if fixed else step)
                params, opt, met = step_fn(params, opt, b)
                del b
                lr = float(optimizer.schedule(tcfg.opt,
                                              torch.tensor(step + 1.0)))
                with torch.no_grad():
                    after0 = float(model.train_loss(batch_of(0),
                                                    params)[0])
                line = {"run": run, "step": step + 1,
                        "loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"]),
                        "loss_on_batch0_after": after0, "lr": lr}
                if run == "shipped" and step == 0:
                    moved = {}
                    for name, p, i, x in zip(_names(params), leaves, picks,
                                             before):
                        d = (p.detach().flatten()[i].float() - x).abs()
                        moved[name] = {
                            "changed_share": (d > 0).float().mean().item(),
                            "max_over_lr": d.max().item() / lr,
                            "rms_over_lr": d.square().mean().sqrt().item()
                            / lr}
                    line["moved_by_leaf"] = moved
                print(json.dumps(line), flush=True)
            print(json.dumps({"run": run, "max_memory_allocated_bytes":
                              torch.cuda.max_memory_allocated()}),
                  flush=True)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"run": run, "error": "OutOfMemoryError",
                              "detail": str(e).splitlines()[0]}),
                  flush=True)
        model = params = opt = step_fn = None
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
