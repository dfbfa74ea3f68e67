"""Architecture registry of the port (a copy of `repro.configs`, the
same values): `get_config("<arch-id>")` and
`get_config("<arch-id>", reduced=True)` for CPU smoke tests."""
from __future__ import annotations

import importlib

# Package surface: re-exported for `from repro_torch.configs import ...`.
from .base import (SHAPES, ArchConfig, ShapeConfig,  # noqa: F401
                   shape_applicable)

ARCH_IDS = (
    "phi3_5_moe_42b",
    "kimi_k2_1t",
    "gemma_7b",
    "qwen3_0_6b",
    "nemotron_4_340b",
    "qwen2_7b",
    "mamba2_1_3b",
    "llama_3_2_vision_90b",
    "jamba_v0_1_52b",
    "hubert_xlarge",
)

# Accept the assignment's dashed ids too.
_ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "gemma-7b": "gemma_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen2-7b": "qwen2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "hubert-xlarge": "hubert_xlarge",
}


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{arch}", __name__)
    return mod.reduced() if reduced else mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
