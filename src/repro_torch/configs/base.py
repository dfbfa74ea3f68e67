"""Architecture configuration schema of the port's model zoo: a copy
of `repro.configs.base` (pure dataclasses), kept here so the port
imports nothing of the reference.

Every assigned architecture gets one `<id>.py` in this package defining
`CONFIG` with the exact public dimensions, plus a `reduced()` variant
used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1      # MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.25

    # --- attention details ---
    activation: str = "swiglu"     # swiglu | geglu | relu2 | gelu
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True            # False => encoder-only
    rope_theta: float = 10000.0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_layer_period: int = 0     # hybrid: 1 attention layer every k

    # --- multimodal ---
    cross_attn_period: int = 0     # vlm: cross-attn every k-th layer
    n_image_tokens: int = 0
    modality: str = "text"         # text | audio | vision+text

    # --- numerics / training ---
    norm_eps: float = 1e-6
    optimizer: str = "adam"        # adam | adafactor (1T-class states)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    # provenance
    source: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.family in ("dense", "vlm", "audio"):
            assert self.n_experts == 0
        if self.family == "ssm":
            assert self.ssm_state > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            # Jamba 1:7 — one attention layer per `attn_layer_period`.
            return i % self.attn_layer_period == self.attn_layer_period // 2
        return True

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_layer_period
                                       == self.moe_layer_period - 1)

    def is_cross_attn_layer(self, i: int) -> bool:
        return (self.cross_attn_period > 0
                and i % self.cross_attn_period == self.cross_attn_period - 1)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        p = self.vocab_size * self.d_model * 2          # embed + unembed
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid") and not self.is_attn_layer(i):
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                p += self.d_model * (2 * di + 2 * ds + nh)   # in_proj
                p += di * self.d_model                       # out_proj
                p += 3 * nh                                  # A, D, dt_bias
            elif self.is_attn_layer(i):
                p += self.d_model * (self.q_dim + 2 * self.kv_dim)
                p += self.q_dim * self.d_model
            if self.is_cross_attn_layer(i):
                p += self.d_model * (self.q_dim + 2 * self.kv_dim)
                p += self.q_dim * self.d_model
            n_ff_mats = 3 if self.activation in ("swiglu", "geglu") else 2
            if self.is_moe_layer(i):
                p += (self.n_experts * n_ff_mats * self.d_model * self.d_ff
                      + self.d_model * self.n_experts)
            elif self.family not in ("ssm",):
                p += n_ff_mats * self.d_model * self.d_ff
        return p

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.n_params()
        p = self.n_params()
        n_ff_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        all_e = n_moe_layers * self.n_experts * n_ff_mats * self.d_model \
            * self.d_ff
        act_e = n_moe_layers * self.experts_per_token * n_ff_mats \
            * self.d_model * self.d_ff
        return p - all_e + act_e


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str               # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules (DESIGN.md Sec. 7)."""
    if shape.mode == "decode" and not cfg.causal:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k requires sub-quadratic attention"
    return True, ""
