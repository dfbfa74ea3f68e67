"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba+attention 1:7 interleave, MoE 16 experts top-2 every
other layer.  [arXiv:2403.19887]  The SSM blocks use our Mamba-2 SSD
implementation (Jamba itself uses Mamba-1; adaptation noted in
DESIGN.md)."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_layer_period=2,
    activation="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_layer_period=8,
    source="arXiv:2403.19887",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, n_experts=4,
        experts_per_token=2, ssm_state=32, ssm_head_dim=32, ssm_chunk=64,
        attn_layer_period=2)
