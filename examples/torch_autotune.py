"""DOSA's one-loop gradient search retargeted at matmul tile shapes on
the PyTorch port (the TPU v5e block-cost model the tuner descends),
then the tuned matmul run on the device and held against its plain
version.

    PYTHONPATH=src python examples/torch_autotune.py [--device cuda]

The counterpart of examples/autotune_tpu.py: on the card the matmul is
the hand-written CUDA kernel, on the CPU its plain version.
"""
import argparse

import torch

from repro_torch.core.autotune import tune_matmul_blocks
from repro_torch.core.tpu_model import matmul_latency
from repro_torch.kernels.matmul.matmul import matmul
from repro_torch.kernels.matmul.ref import matmul_ref

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)

M, N, K = 1024, 2048, 512
print(f"tuning blocks for ({M} x {K}) @ ({K} x {N}) on the TPU v5e "
      f"analytical model, on {dev}...")
res = tune_matmul_blocks(M, N, K, steps=200, device=dev)
bm, bn, bk = res.blocks
b128 = torch.tensor(128.0)
base, _ = matmul_latency(M, N, K, b128, b128, b128)
print(f"  tuned blocks (bm,bn,bk) = {res.blocks}")
print(f"  predicted latency {res.latency_s*1e6:.1f} us "
      f"(128^3 baseline {float(base)*1e6:.1f} us, "
      f"{float(base)/res.latency_s:.2f}x)")
print(f"  VMEM footprint {res.vmem_bytes/2**20:.1f} MiB")

gen = torch.Generator(dev).manual_seed(0)
x = torch.randn((M, K), generator=gen, device=dev)
y = torch.randn((K, N), generator=gen, device=dev)
out = matmul(x, y, bm=bm, bk=bk, bn=bn)
err = float((out - matmul_ref(x, y)).abs().max())
print(f"  kernel vs plain max |err| = {err:.2e}")
if not err < 1e-3:
    raise SystemExit(f"tuned matmul disagrees with its plain version: {err}")
print("OK")
