"""How far Mamba-2's bfloat16 prefill and its bfloat16 decode steps drift
apart, in the reference and in the port, on the same parameters and the
same tokens, on the CPU.

    PYTHONPATH=src python tests/torch_drift_mamba2.py \
        [--width 512] [--layers 48] [--seeds 0 1 2 3] [--tokens 512] \
        [--init reference|port]

For each seed: `mamba2_1_3b` with `d_model` and `n_layers` set as given
(the rest of its config as published), bfloat16 compute, parameters
from the reference's `LM.init(PRNGKey(seed))` carried into the port
with `convert.lm_params_from_numpy` (`--init port`: from the port's
`build_model` on a CPU generator seeded `seed`, carried into the
reference), `--batch` prompts of `--tokens` numpy-drawn tokens.  Each
package's prefill of the prompts gives its last logits; stepping its
`decode_step` through the same tokens gives them again (the chunked
SSD against the exact recurrence).  Prints one
JSON line a seed: each package's largest |prefill - decode| and the
largest |logit|, and the port's largest distance from the reference in
each path.  `chip_smoke.py` gates the port's bfloat16 gap at full size
on the card at a bound set from these readings (PERF.md).  Not
collected by pytest: at the defaults a seed takes about two minutes.
"""
import argparse
import dataclasses
import json
import time


def drift(width: int, layers: int, seed: int, tokens: int, batch: int,
          init: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as r_get_config
    from repro.models.lm import build_model as r_build
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    over = dict(d_model=width, n_layers=layers, compute_dtype="bfloat16")
    rcfg = dataclasses.replace(r_get_config("mamba2_1_3b"), **over)
    cfg = dataclasses.replace(get_config("mamba2_1_3b"), **over)
    ref = r_build(rcfg)
    if init == "reference":
        params, _ = ref.init(jax.random.PRNGKey(seed))
        port = convert.lm_params_from_numpy(
            cfg, jax.tree.map(np.asarray, params), device="cpu")
    else:
        port = build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
        params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                              port.params)
    toks = np.random.default_rng(seed).integers(1, cfg.vocab_size,
                                                (batch, tokens))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)

    t0 = time.perf_counter()
    r_pre = np.asarray(jax.jit(ref.prefill)(params, {"tokens": jt})[0])
    r_cache, step = ref.init_cache(batch, tokens), jax.jit(ref.decode_step)
    for pos in range(tokens):
        r_dec, r_cache = step(params, r_cache, jt[:, pos:pos + 1],
                              jnp.int32(pos))
    r_dec = np.asarray(r_dec)
    t1 = time.perf_counter()
    with torch.no_grad():
        t_pre = port.prefill({"tokens": tt})[0].float().numpy()
        t_cache = port.init_cache(batch, tokens)
        for pos in range(tokens):
            t_dec, t_cache = port.decode_step(t_cache, tt[:, pos:pos + 1],
                                              pos)
    t_dec = t_dec.float().numpy()
    t2 = time.perf_counter()

    def gap(a, b):
        return float(np.abs(a - b).max())

    return {"width": width, "layers": layers, "seed": seed, "init": init,
            "tokens": tokens, "batch": batch,
            "reference_gap": gap(r_pre, r_dec), "port_gap": gap(t_pre, t_dec),
            "max_abs_logit": float(np.abs(r_pre).max()),
            "port_vs_reference_prefill": gap(t_pre, r_pre),
            "port_vs_reference_decode": gap(t_dec, r_dec),
            "reference_seconds": t1 - t0, "port_seconds": t2 - t1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--init", choices=("reference", "port"),
                    default="reference")
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(drift(args.width, args.layers, seed, args.tokens,
                               args.batch, args.init)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
