"""qwen2-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
QKV bias.  [arXiv:2407.10671]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    activation="swiglu",
    qkv_bias=True,
    source="arXiv:2407.10671",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=384, vocab_size=512)
