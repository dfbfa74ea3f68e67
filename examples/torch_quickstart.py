"""Quickstart on the PyTorch port: DOSA one-loop co-search on ResNet-50,
on the card unless asked otherwise.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]

The counterpart of examples/quickstart.py.  It also re-evaluates the
best mappings with the numpy oracle, which must give the best EDP.
"""
import argparse

from repro_torch.core.oracle import evaluate_workload
from repro_torch.core.search import SearchConfig, dosa_search
from repro_torch.workloads.dnn_zoo import resnet50

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

wl = resnet50()
print(f"workload: {wl.name} ({len(wl)} unique layers, "
      f"{wl.total_macs/1e9:.1f} GMACs), device: {args.device}")

cfg = SearchConfig(steps=300, round_every=150, n_start_points=2, seed=0)
res = dosa_search(wl, cfg, device=args.device)
oracle_edp, _ = evaluate_workload(res.best_mappings, wl.layers)

print(f"\nbest EDP: {res.best_edp!r}  (uJ x cycles)")
print(f"oracle EDP of the best mappings: {oracle_edp!r}")
print(f"start-point EDPs: {['%.2e' % e for e in res.start_edps]}")
print(f"improvement over best start: "
      f"{min(res.start_edps)/res.best_edp:.2f}x")
print(f"model evaluations: {res.n_evals}")
print(f"inferred minimal hardware: {res.best_hw.pe_dim}x"
      f"{res.best_hw.pe_dim} PEs, {res.best_hw.acc_kb:.0f} KB "
      f"accumulator, {res.best_hw.sp_kb:.0f} KB scratchpad")
if oracle_edp != res.best_edp:
    raise SystemExit("the oracle disagrees with the search's best EDP")
