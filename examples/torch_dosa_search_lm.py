"""DOSA accelerator co-search for an assigned LM architecture on the
PyTorch port: lower an LM's prefill into the 7-dim layer algebra and
co-design a Gemmini-class accelerator for it.

Runs the fused population engine by default (all start points advance
together on the device); `--sequential` uses the per-start driver.

    PYTHONPATH=src python examples/torch_dosa_search_lm.py [arch] [shape] \\
        [--sequential] [--device cuda]

The counterpart of examples/dosa_search_lm.py.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.search import SearchConfig, dosa_search
from repro_torch.workloads.lm_extract import extract

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="qwen3_0_6b")
ap.add_argument("shape", nargs="?", default="prefill_32k")
ap.add_argument("--sequential", action="store_true")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = get_config(args.arch)
wl = extract(cfg, SHAPES[args.shape])
print(f"{cfg.name} x {args.shape}: {len(wl)} unique GEMM layers, "
      f"{wl.total_macs/1e12:.2f} TMACs")
for layer in wl.layers:
    print(f"  {layer.name:16s} dims={layer.dims} x{layer.repeat}")

search_cfg = SearchConfig(steps=300, round_every=150, n_start_points=8,
                          seed=0)
res = dosa_search(wl, search_cfg,
                  population=None if args.sequential else
                  search_cfg.n_start_points, device=args.device)
print(f"\nengine: {'sequential' if args.sequential else 'batched'} "
      f"({search_cfg.n_start_points} start points, {args.device})")
print(f"best EDP: {res.best_edp:.4e}  ({res.n_evals} samples)")
print(f"hardware: {res.best_hw.pe_dim}x{res.best_hw.pe_dim} PEs, "
      f"acc {res.best_hw.acc_kb:.0f} KB, sp {res.best_hw.sp_kb:.0f} KB")
