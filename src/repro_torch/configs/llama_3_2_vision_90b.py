"""llama-3.2-vision-90b — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attention image layers (every 5th layer).  Vision
frontend is a stub per assignment: `input_specs` supplies precomputed
patch embeddings.  [hf:meta-llama/Llama-3.2-11B-Vision, 90B scaling]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    activation="swiglu",
    cross_attn_period=5,
    n_image_tokens=4096,
    modality="vision+text",
    optimizer="adafactor",
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B variant)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=384, vocab_size=512, cross_attn_period=3,
        n_image_tokens=16)
