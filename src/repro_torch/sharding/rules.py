"""Sharding rules: logical axis names -> mesh PartitionSpecs.  The port
of `repro.sharding.rules`, the same table and functions, held as data.

Mesh axes (`launch.mesh`):
  * "pod"   — data parallelism across pods,
  * "data"  — data parallelism + FSDP/ZeRO within a pod,
  * "model" — tensor/expert parallelism within a pod,
  * "pop"   — co-search population / fleet-member axis.

Parallelism map:
  * batch:       ("pod", "data")
  * TP:          attention heads / d_ff / vocab over "model"
  * FSDP:        parameter d_model (or widest non-TP) dim over "data";
                 optimizer state inherits parameter sharding (ZeRO)
  * EP:          MoE experts over "model"
  * SP:          long-context activations over "data" (sequence dim)

The port runs on one card, so nothing here places a tensor: the
dry-run (`launch.cells`) reads the specs to divide each leaf's bytes
per device.  `PartitionSpec` is the port's own: a tuple with one entry
per tensor dim, each None (replicated), a mesh axis name, or a tuple of
axis names, as `jax.sharding.PartitionSpec` holds them.
"""
from __future__ import annotations


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name, or a tuple of
    axis names; `PartitionSpec()` is replicated whatever the rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Production mesh axis widths (launch/mesh.py), used at init time to
# pick divisibility-safe parameter shardings.
POD_AXIS_SIZE = 2
DATA_AXIS_SIZE = 16
MODEL_AXIS_SIZE = 16

# logical name -> mesh axes (None = replicated)
LOGICAL_RULES: dict[str | None, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "batch_data": "data",
    "seq": None,
    "seq_sp": "data",          # sequence-parallel variant
    "vocab": "model",
    "embed": "data",           # FSDP shard of d_model
    "embed_tp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "image": None,
    "layers": None,            # stacked leading axis
    None: None,
}


def spec(*logical: str | None) -> PartitionSpec:
    """PartitionSpec from logical axis names, e.g.
    spec("embed", "mlp") -> P("data", "model")."""
    return P(*(LOGICAL_RULES[name] for name in logical))


def batch_spec(extra_dims: int = 1) -> PartitionSpec:
    return P(("pod", "data"), *([None] * extra_dims))


# --- population ("pop") axis specs for the sharded co-search engines.
POP_AXIS = "pop"
LOGICAL_RULES["members"] = POP_AXIS     # population / fleet-member axis


def member_spec(extra_dims: int = 0) -> PartitionSpec:
    """(P, ...) member-leading tensors: theta, orders, SpecParams
    leaves.  `extra_dims` trailing dims stay unsharded."""
    return P(POP_AXIS, *([None] * extra_dims))


def segment_member_spec(extra_dims: int = 0) -> PartitionSpec:
    """(S, P, ...) per-segment stacked outputs of the fused loop: the
    segment axis leads, the member axis is sharded."""
    return P(None, POP_AXIS, *([None] * extra_dims))


# Activation specs.  Attention uses Ulysses-style sequence parallelism
# over "model" (all-to-all between D-sharded projections and S-sharded
# attention core).
ACT_TOKENS = P(("pod", "data"), None, None)          # (B, S, D)
ACT_TOKENS_TP = P(("pod", "data"), None, "model")    # (B, S, D_tp)
ACT_Q_ULYSSES = P(("pod", "data"), None, "model", None)  # (B,H,S_tp,hd)
ACT_KV_GATHERED = P(("pod", "data"), None, None, None)   # (B,Hkv,S,hd)
ACT_KV_DECODE = P(("pod", "data"), None, "model", None)  # cache: S_tp
ACT_GROUPS = P(("pod", "data"), None, None)          # MoE (G, T, D)


# Parallelism mode: "tp" (default: TP/EP over "model") or "dp" (pure
# data parallelism: "model" joins the batch axes; weights replicated
# across it).  The hillclimb flips it for small models whose activation
# collectives dominate under 16-way TP.
_PARALLELISM = "tp"


def set_parallelism(mode: str) -> None:
    global _PARALLELISM
    if mode not in ("tp", "dp"):
        raise ValueError(f"parallelism mode {mode!r} is not 'tp' or 'dp'")
    _PARALLELISM = mode


def _apply_mode(pspec: PartitionSpec) -> PartitionSpec:
    if _PARALLELISM == "tp":
        return pspec
    out = []
    for e in pspec:
        if e == "model":
            out.append(None)
        elif (isinstance(e, (tuple, list)) and "data" in e
              and "model" not in e):
            out.append(tuple(e) + ("model",))
        else:
            out.append(e)
    return P(*out)


def sanitize_spec(pspec: PartitionSpec, axis_names) -> PartitionSpec:
    """Apply the parallelism mode, then drop mesh-axis names not present
    in the active mesh (e.g. "pod" on the single-pod mesh)."""
    out = []
    for entry in _apply_mode(pspec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axis_names)
            out.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
        else:
            out.append(entry if entry in axis_names else None)
    return P(*out)
