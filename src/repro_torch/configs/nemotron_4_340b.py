"""nemotron-4-340b — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="relu2",
    optimizer="adafactor",
    param_dtype="bfloat16",
    source="arXiv:2402.16819",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
        head_dim=32, d_ff=768, vocab_size=512)
