"""PyTorch/CUDA port of the DOSA reproduction.

A second package beside the JAX reference `repro`: the same one-loop
co-search (`core.search.dosa_search`, `core.fleet.fleet_search`, both
through `api.run_request`), the co-search service behind its HTTP
front-end (`serve.cosearch_service`, `serve.server`, with `runtime`,
`checkpoint` and the telemetry spine `obs`), the same TPU block-cost
autotuner (`core.autotune`), the dense LM, and the tiled matmul and
flash attention as hand-written Hopper kernels (`kernels`).  It imports torch, numpy and the standard library,
never jax and nothing of `repro`.  Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""
