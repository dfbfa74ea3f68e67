"""Full-width parity check of the port against the JAX reference: the
paper's co-search protocol (benchmarks/fig7_cosearch.py: steps=1490,
round_every=500, 7 start points) on ResNet-50's 21 deduplicated layers,
Gemmini spec, fused engines with population=7, both on the CPU.

    PYTHONPATH=src python tests/torch_parity_resnet50.py

Prints one JSON line per package, then which results are equal; exits
non-zero unless `best_edp`, `n_evals` and `start_edps` are.  The
`history` is reported, not required: at this width the two frameworks'
gradients agree to ~1e-7 of their scale, but entries that are zero up
to rounding come out as different tiny values, Adam's normalisation
turns each into a full step, and a few factors round to a neighbouring
divisor after 500 steps — so intermediate candidates (and with them
the history) may differ while the best found agrees.  Not collected by
pytest (it takes about a minute); `chip_smoke.py` runs the port's side
of the same protocol on the card.
"""
import json
import sys
import time


def main() -> int:
    from repro.core.search import SearchConfig as RConfig
    from repro.core.search import dosa_search as r_search
    from repro.workloads.dnn_zoo import resnet50 as r_resnet50
    from repro_torch.core.search import SearchConfig as TConfig
    from repro_torch.core.search import dosa_search as t_search
    from repro_torch.workloads.dnn_zoo import resnet50 as t_resnet50

    proto = dict(steps=1490, round_every=500, n_start_points=7, seed=0)
    t0 = time.perf_counter()
    ref = r_search(r_resnet50(), RConfig(**proto), population=7)
    t1 = time.perf_counter()
    got = t_search(t_resnet50(), TConfig(**proto), population=7,
                   device="cpu")
    t2 = time.perf_counter()
    for name, res, secs in (("reference", ref, t1 - t0),
                            ("port", got, t2 - t1)):
        print(json.dumps({"package": name, "device": "cpu",
                          "best_edp": res.best_edp, "n_evals": res.n_evals,
                          "host_seconds": secs}))
    checks = {"best_edp": got.best_edp == ref.best_edp,
              "n_evals": got.n_evals == ref.n_evals,
              "start_edps": got.start_edps == ref.start_edps,
              "history": got.history == ref.history}
    first = next((i for i, (a, b) in enumerate(zip(got.history,
                                                   ref.history))
                  if a != b), None)
    required = ("best_edp", "n_evals", "start_edps")
    ok = all(checks[k] for k in required)
    print(json.dumps({"equal": ok, **checks,
                      "first_history_difference": first}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
