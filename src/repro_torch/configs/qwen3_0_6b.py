"""qwen3-0.6b — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936,
qk_norm, head_dim=128.  [hf:Qwen/Qwen3-0.6B family]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B family card",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=384, vocab_size=512)
