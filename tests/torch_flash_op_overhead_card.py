"""Host cost of the flash kernels' custom-op route on the card.  Needs
an NVIDIA GPU.

    PYTHONPATH=src python tests/torch_flash_op_overhead_card.py \
        [--calls 2000] [--rounds 4]

Since the flash forward and backward became `torch.library` custom ops
(`repro_torch::flash_fwd`, `repro_torch::flash_bwd`), every call passes
the dispatcher before the ctypes launch.  This times, on the host clock
over `--calls` calls at a small bf16 shape q (1, 2, 64, 128), where the
host and not the kernel bounds a call: `attend` and `attend_backward`
(the operand checks and the op's dispatch), and the same checks with
the op's CUDA implementation called directly (the launch the wrappers
made before the ops).  The two routes alternate `--rounds` times (op,
direct, direct, op, ...).  Prints microseconds per call of each route,
their medians and difference, beside the card's name and power limit,
as one JSON line.  Both routes launch the same kernel: their launch
counts are checked equal.  Not collected by pytest.
"""
import argparse
import json
import statistics
import subprocess
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for name in ("flash_attention", "flash_attention_bwd"):
        build.build(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 2, 64, 128), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out, lse = fa.attend(q, k, v, causal=True, return_lse=True)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    fwd_direct = fa.flash_fwd._init_fn
    bwd_direct = fa.flash_bwd._init_fn

    routes = {
        "fwd_op": lambda: fa.attend(q, k, v, causal=True),
        "fwd_direct": lambda: (fa._check_kernel_operands(q, k, v, 0),
                               fwd_direct(q, k, v, True, 0, False)),
        "bwd_op": lambda: fa.attend_backward(q, k, v, out, do, lse,
                                             causal=True),
        "bwd_direct": lambda: (fa._check_kernel_operands(q, k, v, 0),
                               bwd_direct(q, k, v, out, do, lse, True, 0)),
    }

    def per_call_us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.calls * 1e6

    for fn in routes.values():                  # warm
        fn()
    times = {name: [] for name in routes}
    launches = {}
    for r in range(args.rounds):
        for kind in ("fwd", "bwd"):
            order = ("op", "direct") if r % 2 == 0 else ("direct", "op")
            for route in order:
                name = f"{kind}_{route}"
                before = (fa.flash_attention.launches,
                          fa.attend_backward.launches)
                times[name].append(per_call_us(routes[name]))
                launches[name] = (fa.flash_attention.launches - before[0],
                                  fa.attend_backward.launches - before[1])
    for kind in ("fwd", "bwd"):
        if launches[f"{kind}_op"] != launches[f"{kind}_direct"]:
            raise SystemExit(f"{kind}: launches differ {launches}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    med = {name: statistics.median(t) for name, t in times.items()}
    print(json.dumps({
        "shape_q": list(q.shape), "dtype": "bfloat16", "calls": args.calls,
        "us_per_call": times, "median_us_per_call": med,
        "op_cost_us_fwd": med["fwd_op"] - med["fwd_direct"],
        "op_cost_us_bwd": med["bwd_op"] - med["bwd_direct"],
        "launches_per_round": launches, "nvidia_smi": smi,
        "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
