"""mamba2-1.3b — 48L d_model=2048, attention-free SSD (state-space
duality), ssm_state=128.  [arXiv:2405.21060]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2405.21060",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, ssm_state=32, ssm_head_dim=32,
        ssm_chunk=64, vocab_size=512)
