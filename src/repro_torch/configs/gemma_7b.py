"""gemma-7b — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256.  [arXiv:2403.08295]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    source="arXiv:2403.08295",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512)
