#!/usr/bin/env python3
"""Same-card A/B timing of the port's bf16 tensor-core kernels across
source trees.

    python3 chip_kernel_ab.py NAME=DIR [NAME=DIR ...]

Each DIR holds kernel sources as in `src/repro_torch/kernels/csrc`
(`matmul.cu`, `flash_attention.cu` and the headers they include): this
checkout's, or another commit's unpacked with `git archive` into a
directory `.gitignore` lists.  The flash entry takes the optional
log-sum-exp pointer after the output (passed null here), so a tree
must be of a commit whose entry has it.  Each tree is built with the
port's nvcc flags into `build/kernel_ab/NAME/`.  Its wgmma entries
then run at the main path's shapes (the matmul at the Qwen3-0.6B FFN
shape, flash attention at the prefill shape, bf16, causal) and are
held against the plain versions (2e-2).  Then they are timed in turns
(the trees in order, then reversed, twice over).  Each time is the
median of 15 runs of 20 back-to-back launches between a pair of CUDA
events.  It prints one JSON line per tree, then the card's name and
power limit.  Needs one card; compare trees only within one run.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FFN_M, FFN_K, FFN_N = 4096, 1024, 3072
B, HQ, HKV, S, D = 4, 16, 8, 4096, 128
TOL = 2e-2


def build_tree(build, name: str, src: Path) -> dict:
    """Compile the tree's two kernel sources; the loaded libraries."""
    out_dir = ROOT / "build" / "kernel_ab" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for stem in ("matmul", "flash_attention"):
        lib = out_dir / f"lib{stem}.so"
        proc = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(src / f"{stem}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src / stem}.cu:\n"
                               f"{proc.stderr}")
        libs[stem] = ctypes.CDLL(str(lib))
    mm = libs["matmul"].repro_matmul_bf16_wgmma
    mm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fa = libs["flash_attention"].repro_flash_attention_bf16_wgmma
    fa.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    return {"matmul": mm, "flash": fa}


def cuda_ms(torch, fn, reps: int = 20, iters: int = 15) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.matmul.ref import matmul_ref

    trees = dict(arg.split("=", 1) for arg in argv)
    fns = {name: build_tree(build, name, Path(src))
           for name, src in trees.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    x, y = randn(FFN_M, FFN_K), randn(FFN_K, FFN_N)
    q, k, v = randn(B, HQ, S, D), randn(B, HKV, S, D), randn(B, HKV, S, D)
    mm_out = torch.empty((FFN_M, FFN_N), dtype=torch.bfloat16,
                         device="cuda")
    fa_out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, which):
        if which == "matmul":
            rc = fns[name]["matmul"](x.data_ptr(), y.data_ptr(),
                                     mm_out.data_ptr(), FFN_M, FFN_N, FFN_K,
                                     stream)
        else:
            rc = fns[name]["flash"](q.data_ptr(), k.data_ptr(),
                                    v.data_ptr(), fa_out.data_ptr(), None,
                                    B, HQ, HKV, S, S, D, 1, 0, D ** -0.5,
                                    stream)
        if rc != 0:
            raise RuntimeError(f"{name} {which}: launch failed ({rc})")

    mm_ref = matmul_ref(x, y).float()
    group = HQ // HKV
    fa_ref = attention_ref(  # batch 0 only, to bound the plain version
        q[0], k[0].repeat_interleave(group, 0),
        v[0].repeat_interleave(group, 0), causal=True).float()
    rows = {}
    for name in trees:
        run(name, "matmul")
        run(name, "flash")
        torch.cuda.synchronize()
        pairs = {"matmul": (mm_out.float(), mm_ref),
                 "flash": (fa_out[0].float(), fa_ref)}
        errs = {}
        for which, (got, ref) in pairs.items():
            torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
            errs[which] = (got - ref).abs().max().item()
        rows[name] = {"tree": name, "dir": trees[name],
                      "max_abs_err": errs, "matmul_ms": [], "flash_ms": []}
    order = list(trees) + list(trees)[::-1]
    for name in order * 2:
        for which in ("matmul", "flash"):
            rows[name][f"{which}_ms"].append(
                cuda_ms(torch, lambda: run(name, which)))
    for row in rows.values():
        for which in ("matmul", "flash"):
            row[f"{which}_ms_median"] = statistics.median(row[f"{which}_ms"])
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
