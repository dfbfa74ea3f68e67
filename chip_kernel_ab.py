#!/usr/bin/env python3
"""Same-card A/B timing of the port's bf16 kernels across source trees.

    python3 chip_kernel_ab.py NAME=DIR [NAME=DIR ...]

Each DIR holds kernel sources as in `src/repro_torch/kernels/csrc`
(`matmul.cu`, `flash_attention.cu`, `flash_attention_bwd.cu` and the
headers they include): this checkout's, or another commit's unpacked
with `git archive` into a directory `.gitignore` lists.  The flash
entry takes the optional log-sum-exp pointer after the output (passed
null here), and the backward entry `repro_flash_attention_bwd_bf16`
must exist, so a tree must be of a commit whose entries have both (the
training slice's on).  Each tree is built with the port's nvcc flags
into `build/kernel_ab/NAME/`.  Its bf16 entries then run at the main
path's shapes (the matmul at the Qwen3-0.6B FFN shape, flash attention
at the prefill shape, the backward at that shape and at the training
shape of Qwen3-0.6B, q (8, 16, 512, 128); bf16, causal) and are held
against the plain versions (2e-2; the backward's gradients within 2e-2
of the plain gradient's largest magnitude, from the plain forward's
output and log-sum-exp, which both trees get).  Then they are timed in
turns (the trees in order, then reversed, twice over).  Each time is
the median of 15 runs of 20 back-to-back launches between a pair of
CUDA events (the backward at the prefill shape: 5 runs of one launch).
It prints one JSON line per tree, then the card's name and power
limit.  Needs one card; compare trees only within one run.
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
# The backward's shapes (b, hq, hkv, s, d): the prefill shape and the
# training shape of Qwen3-0.6B.
BWD_SHAPES = {"bwd_flash": (B, HQ, HKV, S, D), "bwd_train": (8, 16, 8, 512, D)}
TOL = 2e-2


def build_tree(build, name: str, src: Path) -> dict:
    """Compile the tree's three kernel sources; their bf16 entries."""
    out_dir = ROOT / "build" / "kernel_ab" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for stem in ("matmul", "flash_attention", "flash_attention_bwd"):
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
    bwd = libs["flash_attention_bwd"].repro_flash_attention_bwd_bf16
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    return {"matmul": mm, "flash": fa, "bwd": bwd}


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
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)
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
    # Backward inputs (q, k, v, o, do, lse from the plain forward) and
    # outputs (dq, dk, dv, delta scratch) per shape.
    bwd = {}
    for which, (b, hq, hkv, s, d) in BWD_SHAPES.items():
        bq, bk, bv, bdo = randn(b, hq, s, d), randn(b, hkv, s, d), \
            randn(b, hkv, s, d), randn(b, hq, s, d)
        bo, blse = attention_lse_ref(bq, bk, bv, causal=True)
        ins = (bq, bk, bv, bo, bdo, blse)
        outs = [torch.empty_like(t) for t in (bq, bk, bv)]
        delta = torch.empty_like(blse)
        bwd[which] = {"in": ins, "out": outs, "delta": delta, "args": (
            *(t.data_ptr() for t in (*ins, delta, *outs)),
            b, hq, hkv, s, s, d, 1, 0, d ** -0.5, stream)}

    def run(name, which):
        if which in bwd:
            rc = fns[name]["bwd"](*bwd[which]["args"])
        elif which == "matmul":
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
    bwd_ref = {which: attention_bwd_ref(*t["in"], causal=True)
               for which, t in bwd.items()}
    kernels = ("matmul", "flash", *BWD_SHAPES)
    rows = {}
    for name in trees:
        for which in kernels:
            run(name, which)
        torch.cuda.synchronize()
        pairs = {"matmul": (mm_out.float(), mm_ref),
                 "flash": (fa_out[0].float(), fa_ref)}
        errs = {}
        for which, (got, ref) in pairs.items():
            torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
            errs[which] = (got - ref).abs().max().item()
        for which, t in bwd.items():
            shares = [((g.float() - w.float()).abs().max()
                       / w.float().abs().max()).item()
                      for g, w in zip(t["out"], bwd_ref[which])]
            if max(shares) > TOL:
                raise AssertionError(f"{name} {which}: error shares "
                                     f"{shares} of the largest gradient")
            errs[which] = max(shares)
        rows[name] = {"tree": name, "dir": trees[name],
                      "max_abs_err": errs,
                      **{f"{which}_ms": [] for which in kernels}}
    order = list(trees) + list(trees)[::-1]
    for name in order * 2:
        for which in kernels:
            slow = which == "bwd_flash"
            rows[name][f"{which}_ms"].append(
                cuda_ms(torch, lambda: run(name, which),
                        reps=1 if slow else 20, iters=5 if slow else 15))
    for row in rows.values():
        for which in kernels:
            row[f"{which}_ms_median"] = statistics.median(row[f"{which}_ms"])
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
