"""hubert-xlarge — 48L d_model=1280 16H d_ff=5120 vocab=504,
encoder-only (bidirectional), audio.  The conv feature extractor is a
stub per assignment: `input_specs` supplies precomputed frame
embeddings.  [arXiv:2106.07447]"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    causal=False,
    modality="audio",
    source="arXiv:2106.07447",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=384, vocab_size=128)
