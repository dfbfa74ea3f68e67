"""Plain PyTorch version of the tiled matmul kernel: f32 product, cast
back to the input type.  The wrapper uses it for CPU tensors; the chip
smoke test holds the CUDA kernel against it on the card."""
import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() @ y.float()).to(x.dtype)
