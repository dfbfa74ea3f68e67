"""kimi-k2-1t-a32b — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8.  Trillion-parameter MoE
[arXiv:2501.kimi2].  Uses Adafactor-class optimizer state to fit HBM."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    activation="swiglu",
    optimizer="adafactor",
    param_dtype="bfloat16",
    source="arXiv:2501.kimi2 (paper-table)",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=64, vocab_size=512, n_experts=8,
        experts_per_token=2)
