"""Flash attention: plain PyTorch version (`ref`), the Hopper CUDA
kernel's wrapper (`flash_attention`) and the GQA entry point
(`ops`)."""
