"""Lower the assigned LM architectures x input shapes into DOSA's 7-dim
layer algebra (DESIGN.md Sec. 4), so the paper's co-search runs on e.g.
`kimi-k2 prefill_32k` exactly the way it runs on BERT.  The PyTorch
port's copy of `repro.workloads.lm_extract` (plain Python, no tensors).

Encoding: every GEMM out[M, N_g] = A[M, K_g] @ B[K_g, N_g] becomes a 1x1
conv (P=M, C=K_g, K=N_g).  Per-head attention GEMMs carry
batch x heads x layers repeat counts (their "weights" — the K/V blocks —
are not shared, so repeats, not the conv batch dim, model them).  MoE
expert GEMMs count only routed (active) tokens, matching the
6*N_active*D FLOP accounting used in the roofline analysis.
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig, shape_applicable
from ..core.problem import Layer, Workload, dedupe_layers


def _attn_layers(cfg: ArchConfig, tokens: int, seq: int, batch: int,
                 mode: str, n_attn: int, kv_len: int | None = None,
                 tag: str = "") -> list[Layer]:
    """GEMMs of `n_attn` (self- or cross-) attention layers."""
    if n_attn == 0:
        return []
    kv_len = kv_len if kv_len is not None else seq
    m = tokens if mode != "decode" else batch
    q_rows = seq if mode != "decode" else 1
    out = [
        Layer.matmul(m, cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model,
                     repeat=n_attn, name=f"{tag}qkv"),
        Layer.matmul(m, cfg.d_model, cfg.q_dim, repeat=n_attn,
                     name=f"{tag}attn_out"),
    ]
    # score / context per (batch x q-head); causal prefill halves the
    # effective KV extent on average — we keep the full extent (upper
    # bound), as Timeloop-style models do.
    reps = n_attn * cfg.n_heads * batch
    out += [
        Layer.matmul(q_rows, kv_len, cfg.head_dim, repeat=reps,
                     name=f"{tag}score"),
        Layer.matmul(q_rows, cfg.head_dim, kv_len, repeat=reps,
                     name=f"{tag}context"),
    ]
    return out


def _ffn_layers(cfg: ArchConfig, tokens: int, mode: str, batch: int,
                n_dense: int, n_moe: int) -> list[Layer]:
    m = tokens if mode != "decode" else batch
    n_mats_up = 2 if cfg.activation in ("swiglu", "geglu") else 1
    out = []
    if n_dense:
        out += [
            Layer.matmul(m, cfg.d_ff, cfg.d_model,
                         repeat=n_dense * n_mats_up, name="ffn_up"),
            Layer.matmul(m, cfg.d_model, cfg.d_ff, repeat=n_dense,
                         name="ffn_down"),
        ]
    if n_moe:
        out.append(Layer.matmul(m, cfg.n_experts, cfg.d_model,
                                repeat=n_moe, name="router"))
        # Routed tokens per expert (active compute only).
        m_exp = max(m * cfg.experts_per_token // cfg.n_experts, 1)
        out += [
            Layer.matmul(m_exp, cfg.d_ff, cfg.d_model,
                         repeat=n_moe * cfg.n_experts * n_mats_up,
                         name="expert_up"),
            Layer.matmul(m_exp, cfg.d_model, cfg.d_ff,
                         repeat=n_moe * cfg.n_experts, name="expert_down"),
        ]
    return out


def _ssm_layers(cfg: ArchConfig, tokens: int, mode: str, batch: int,
                n_ssm: int) -> list[Layer]:
    """Mamba-2 SSD GEMMs (state-space duality): projections + chunked
    intra/inter-chunk GEMMs.  The inter-chunk recurrence itself is a
    scan (bandwidth-bound, not MACs) — noted in DESIGN.md Sec. 7."""
    if n_ssm == 0:
        return []
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd, ck = cfg.ssm_head_dim, cfg.ssm_chunk
    m = tokens if mode != "decode" else batch
    out = [
        Layer.matmul(m, 2 * di + 2 * ds + nh, cfg.d_model, repeat=n_ssm,
                     name="ssm_in"),
        Layer.matmul(m, cfg.d_model, di, repeat=n_ssm, name="ssm_out"),
    ]
    if mode == "decode":
        # Recurrent step: per head, state update x^T B and read C h.
        out.append(Layer.matmul(batch, ds, hd, repeat=n_ssm * nh,
                                name="ssm_state_upd"))
        out.append(Layer.matmul(batch, hd, ds, repeat=n_ssm * nh,
                                name="ssm_state_read"))
        return out
    n_chunks = max(tokens // ck, 1)
    reps = n_ssm * nh * n_chunks
    out += [
        # intra-chunk: (c x c) attention-like GEMMs per head per chunk
        Layer.matmul(ck, ck, ds, repeat=reps, name="ssd_intra_score"),
        Layer.matmul(ck, hd, ck, repeat=reps, name="ssd_intra_out"),
        # chunk state build (B^T X) and state emit (C H)
        Layer.matmul(ds, hd, ck, repeat=reps, name="ssd_state_build"),
        Layer.matmul(ck, hd, ds, repeat=reps, name="ssd_state_emit"),
    ]
    return out


def extract(cfg: ArchConfig, shape: ShapeConfig) -> Workload:
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name} skipped: {why}")
    seq, batch, mode = shape.seq_len, shape.global_batch, shape.mode
    tokens = seq * batch

    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    n_ssm = cfg.n_layers - n_attn if cfg.family in ("ssm", "hybrid") else 0
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    n_cross = sum(cfg.is_cross_attn_layer(i) for i in range(cfg.n_layers))
    n_dense_ffn = (cfg.n_layers - n_moe) if cfg.family != "ssm" else 0

    layers: list[Layer] = []
    layers += _attn_layers(cfg, tokens, seq, batch, mode, n_attn)
    if n_cross:
        layers += _attn_layers(cfg, tokens, seq, batch, mode, n_cross,
                               kv_len=cfg.n_image_tokens, tag="x")
    layers += _ffn_layers(cfg, tokens, mode, batch, n_dense_ffn, n_moe)
    layers += _ssm_layers(cfg, tokens, mode, batch, n_ssm)
    # LM head (decode emits one token per sequence).
    m_head = tokens if mode == "train" else (batch if mode == "decode"
                                             else batch)
    layers.append(Layer.matmul(m_head, cfg.vocab_size, cfg.d_model,
                               name="lm_head"))
    wl = dedupe_layers(layers)
    return Workload(layers=wl.layers, name=f"{cfg.name}:{shape.name}")
