"""Co-search a workload portfolio across three accelerator targets in
one fleet run on the PyTorch port: Gemmini, TPU v5e and a 3-level edge
accelerator, each an `ArchSpec` data file.

    PYTHONPATH=src python examples/torch_multi_target_cosearch.py \\
        [--steps N] [--starts N] [--device cuda]

The counterpart of examples/multi_target_cosearch.py: `fleet_search`
groups the specs by hierarchy structure (`engine_group_key`), runs each
group's populations through one batched engine on the device, and
reports every (target, workload) best plus the Pareto frontier in
(energy, latency).
"""
import argparse

from repro_torch.core.archspec import EDGE_SPEC, GEMMINI_SPEC, TPU_V5E_SPEC
from repro_torch.core.fleet import fleet_search
from repro_torch.core.problem import Layer, Workload
from repro_torch.core.search import SearchConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--starts", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    workloads = [
        Workload(layers=(Layer.conv(64, 128, 3, 28, name="conv3x3"),),
                 name="convnet"),
        Workload(layers=(Layer.matmul(512, 1024, 768, name="gemm"),),
                 name="gemm"),
    ]
    cfg = SearchConfig(steps=args.steps,
                       round_every=max(args.steps // 2, 1),
                       n_start_points=args.starts, seed=7)
    res = fleet_search(workloads, (GEMMINI_SPEC, TPU_V5E_SPEC, EDGE_SPEC),
                       cfg, device=args.device)

    front = {id(e) for e in res.frontier()}
    print(f"{'target':>8} {'workload':>9} {'EDP':>11} {'energy pJ':>11} "
          f"{'latency cyc':>12}  pareto")
    for e in res.entries:
        print(f"{e.spec_name:>8} {e.workload:>9} {e.best_edp:11.4e} "
              f"{e.best_energy:11.4e} {e.best_latency:12.4e}  "
              f"{'*' if id(e) in front else ''}")
    print("\nfrontier CSV:\n" + res.to_csv())


if __name__ == "__main__":
    main()
