"""The tiled matmul: plain PyTorch version (`ref`), the Hopper CUDA
kernel's wrapper (`matmul`) and the DOSA-tuned entry point (`ops`)."""
