"""PyTorch/CUDA port of the DOSA reproduction.

A second package beside the JAX reference `repro`: the same one-loop
co-search (`api.dosa_search`), the same TPU block-cost autotuner
(`core.autotune`), and the tiled matmul as a hand-written Hopper kernel
(`kernels.matmul`).  It imports torch, numpy and the standard library,
never jax and nothing of `repro`.  Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""
