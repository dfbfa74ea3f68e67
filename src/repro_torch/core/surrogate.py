"""Learned latency models (paper Sec. 4.7 / 6.5), on torch.

The PyTorch port of `repro.core.surrogate`.  Two small MLPs,
architecture after Mind Mappings [9] as the paper describes — 7 hidden
fully-connected layers, ~5.7k parameters:

* **residual model** — predicts log(latency_RTL / latency_analytical),
  composing with the analytical model ("DNN-augmented analytical");
* **direct model** — predicts log(latency_RTL) from the same features
  ("DNN-only").

Features per sample: log problem dims (7), log tiling factors at the
free sites (19), loop-ordering one-hots (9), log hardware parameters
(3) = 38 inputs.  Both models train with Adam + MSE on a small dataset
of random mappings (the paper uses 1567 FireSim measurements).

Weights keep the reference's ``(in, out)`` layout, so a parameter list
carries across packages as a copy (`convert.surrogate_params_from_numpy`,
and the `.npz` format of `TrainedModel.save`/`load`, which both packages
read and write).  Initial weights come from a seeded `torch.Generator`,
not from `jax.random`: the same `seed` draws a different model here
than in the reference.  `_fit(init_params=...)` takes a starting point
as numpy arrays, which is how the reference's initial weights are
handed over.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from .arch import GemminiHW
from .archspec import GEMMINI_SPEC, compile_spec
from .mapping import Mapping
from .problem import Layer

# The Gemmini GD free mask (the legacy featurization's factor sites).
FREE_MASK = compile_spec(GEMMINI_SPEC).free_mask

N_HIDDEN_LAYERS = 7
HIDDEN = 28          # 7x28 hidden -> 5,993 params (paper: 5,737)
RESIDUAL_CLIP = 2.0  # |log-ratio| bound: "outputs are constrained using
#                      the analytical model prediction" (Sec. 6.5.3)
DIRECT_CLIP = 40.0   # sanity bound on log-latency for the DNN-only model


def featurize(m: Mapping, layer: Layer, hw: GemminiHW) -> np.ndarray:
    """Gemmini feature vector of one (mapping, layer, hardware) sample.

    Gemmini-only by construction: the 19 log-factor features are read at
    the Gemmini `FREE_MASK` sites of a (2, 4, 7) factor tensor and the 3
    hardware features are (pe_dim, acc_kb, sp_kb).  Other targets use
    `calibration.featurize_spec`."""
    if m.f.shape != FREE_MASK.shape or not hasattr(hw, "acc_kb"):
        raise ValueError(
            "the latency surrogate's featurizer is Gemmini-only (log "
            "factors at the Gemmini FREE_MASK sites + (pe_dim, acc_kb, "
            f"sp_kb) hardware features); got a {m.f.shape} factor tensor "
            f"and {type(hw).__name__} hardware.  Non-Gemmini ArchSpecs "
            "use calibration.featurize_spec.")
    dims = np.log(np.asarray(layer.dims, dtype=float))
    factors = np.log(np.maximum(m.f[FREE_MASK], 1.0))
    orders = np.zeros((3, 3))
    for i, lvl in enumerate((1, 2, 3)):
        orders[i, int(m.order[lvl])] = 1.0
    hwf = np.log(np.array([hw.pe_dim, hw.acc_kb, hw.sp_kb], dtype=float))
    return np.concatenate([dims, factors, orders.ravel(), hwf])


N_FEATURES = 7 + int(FREE_MASK.sum()) + 9 + 3


def _layer_sizes(n_in: int, hidden: int, n_hidden: int) -> list[int]:
    return [n_in] + [hidden] * n_hidden + [1]


def init_mlp(generator: torch.Generator, n_in: int = N_FEATURES,
             hidden: int = HIDDEN, n_hidden: int = N_HIDDEN_LAYERS,
             device=DEFAULT_DEVICE) -> list[dict]:
    """He-normal weights ``(in, out)`` and zero biases, float32, drawn on
    the CPU from `generator` (so a seed gives the same model on every
    device) and moved to `device`."""
    dev = resolve_device(device)
    sizes = _layer_sizes(n_in, hidden, n_hidden)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator) * float(np.sqrt(2.0 / a))
        params.append({"w": w.to(dev), "b": torch.zeros(b, device=dev)})
    return params


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """The MLP's forward pass on (..., n_in) features -> (...)."""
    h = x
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[..., 0]


def n_params(params: list[dict]) -> int:
    return sum(p["w"].numel() + p["b"].numel() for p in params)


def _unflatten(flat: torch.Tensor, sizes) -> list[dict]:
    """Views of one flat parameter vector as the layer list (each
    layer's ``w`` row-major (in, out), then its ``b``)."""
    params, at = [], 0
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = flat[at:at + a * b].view(a, b)
        at += a * b
        params.append({"w": w, "b": flat[at:at + b]})
        at += b
    return params


class MLP(nn.Module):
    """The latency MLP as a module.  Its weights live in one flat
    float32 parameter (`flat`) viewed as the reference's per-layer
    ``(in, out)`` weights and biases (`params`), so one Adam update
    covers every layer."""

    def __init__(self, params: list[dict]):
        super().__init__()
        self.sizes = tuple([params[0]["w"].shape[0]]
                           + [p["w"].shape[1] for p in params])
        self.flat = nn.Parameter(torch.cat(
            [t.detach().reshape(-1).to(torch.float32)
             for p in params for t in (p["w"], p["b"])]))

    @property
    def params(self) -> list[dict]:
        return _unflatten(self.flat, self.sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params, x)


@dataclasses.dataclass
class TrainedModel:
    params: list                    # [{"w": (in, out), "b": (out,)}] tensors
    x_mean: np.ndarray
    x_std: np.ndarray
    kind: str                       # "residual" | "direct"
    val_mse: float = float("nan")   # best held-out MSE seen by _fit
    spec_name: str = "gemmini"      # featurization target (calibration)

    @property
    def n_features(self) -> int:
        return int(np.asarray(self.x_mean).shape[0])

    @property
    def device(self) -> torch.device:
        return self.params[0]["w"].device

    def predict_latency(self, feats: np.ndarray,
                        analytical: np.ndarray) -> np.ndarray:
        """Latency of (N, n_features) host features: the MLP runs on the
        model's device in float32, the composition on the host."""
        x = (feats - self.x_mean) / self.x_std
        xt = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
            self.device)
        with torch.no_grad():
            out = mlp_apply(self.params, xt).cpu().numpy()
        if self.kind == "residual":
            return analytical * np.exp(np.clip(out, -RESIDUAL_CLIP,
                                               RESIDUAL_CLIP))
        return np.exp(np.clip(out, 0.0, DIRECT_CLIP))

    def save(self, path) -> None:
        """Persist to one `.npz` artifact (weights + normalization +
        metadata), in the reference's format."""
        arrays = {}
        for i, p in enumerate(self.params):
            arrays[f"w{i}"] = p["w"].detach().cpu().numpy()
            arrays[f"b{i}"] = p["b"].detach().cpu().numpy()
        np.savez(path, n_layers=np.asarray(len(self.params)),
                 x_mean=np.asarray(self.x_mean),
                 x_std=np.asarray(self.x_std),
                 kind=np.asarray(self.kind),
                 val_mse=np.asarray(self.val_mse),
                 spec_name=np.asarray(self.spec_name), **arrays)

    @classmethod
    def load(cls, path, device=DEFAULT_DEVICE) -> "TrainedModel":
        """Load a `.npz` written by either package, weights on
        `device`."""
        from ..convert import surrogate_params_from_numpy

        with np.load(path, allow_pickle=False) as d:
            n_layers = int(d["n_layers"])
            params = surrogate_params_from_numpy(
                [{"w": d[f"w{i}"], "b": d[f"b{i}"]}
                 for i in range(n_layers)], device=device)
            return cls(params=params, x_mean=np.asarray(d["x_mean"]),
                       x_std=np.asarray(d["x_std"]),
                       kind=str(d["kind"]), val_mse=float(d["val_mse"]),
                       spec_name=str(d["spec_name"]))


def _fit(x: np.ndarray, y: np.ndarray, kind: str, epochs: int, lr: float,
         seed: int, weight_decay: float = 3e-4, batch_size: int = 128,
         val_frac: float = 0.15, eval_callback=None,
         spec_name: str = "gemmini", init_params=None,
         device=DEFAULT_DEVICE) -> TrainedModel:
    """Minibatch Adam + L2 on `device`, early-stopped on a held-out
    validation split (keeps the best-validation parameters seen).

    The split, the normalization, and each epoch's minibatch order come
    from `numpy.random.default_rng(seed)` exactly as in the reference.
    Adam is written out as the reference writes it (``m = 0.9 m + 0.1
    g``, bias corrections ``0.9 ** t`` and ``0.999 ** t`` in float32),
    not taken from `torch.optim`.  `init_params` (a list of ``{"w", "b"}``
    numpy arrays) gives the starting weights; without it they come from
    `init_mlp` with a generator seeded by `seed`.  `eval_callback(epoch,
    params, val_mse)` fires at every validation evaluation (every 5th
    epoch and the last)."""
    from ..convert import surrogate_params_from_numpy

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    n_val = max(int(len(x) * val_frac), 1)
    vi, ti = perm[:n_val], perm[n_val:]

    x_mean, x_std = x[ti].mean(0), x[ti].std(0) + 1e-8
    xn = torch.from_numpy(((x - x_mean) / x_std).astype(np.float32)).to(dev)
    yn = torch.from_numpy(np.asarray(y, dtype=np.float32)).to(dev)
    vi_t = torch.from_numpy(vi).to(dev)
    xv, yv = xn[vi_t], yn[vi_t]
    if init_params is None:
        init = init_mlp(torch.Generator().manual_seed(seed),
                        n_in=x.shape[1], device=dev)
    else:
        init = surrogate_params_from_numpy(init_params, device=dev)
    net = MLP(init)
    sizes = net.sizes

    def loss_fn(xb, yb):
        p = net.params
        mse = torch.mean((mlp_apply(p, xb) - yb) ** 2)
        l2 = sum(torch.sum(q["w"] ** 2) for q in p)
        return mse + weight_decay * l2

    def val_mse() -> float:
        with torch.no_grad():
            return float(torch.mean((net(xv) - yv) ** 2))

    n_batches = max(len(ti) // batch_size, 1)
    per_batch = min(batch_size, len(ti))
    ts = torch.arange(1, epochs * n_batches + 1, dtype=torch.float32,
                      device=dev)
    m = torch.zeros_like(net.flat)
    v = torch.zeros_like(net.flat)
    best_val, best_flat, t = np.inf, net.flat.detach().clone(), 0
    for epoch in range(epochs):
        order = rng.permutation(len(ti))
        # The epoch's minibatches, one copy to the device: batch b is
        # ti[order[b * batch_size:(b + 1) * batch_size]].
        idx = torch.from_numpy(
            ti[order[:n_batches * per_batch]].reshape(n_batches, per_batch)
        ).to(dev)
        for b in range(n_batches):
            t += 1
            sl = idx[b]
            (g,) = torch.autograd.grad(loss_fn(xn[sl], yn[sl]), net.flat)
            with torch.no_grad():
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g * g
                mh = m / (1 - 0.9 ** ts[t - 1])
                vh = v / (1 - 0.999 ** ts[t - 1])
                net.flat.copy_(net.flat - lr * mh / (torch.sqrt(vh) + 1e-8))
        if epoch % 5 == 0 or epoch == epochs - 1:
            vm = val_mse()
            if eval_callback is not None:
                eval_callback(epoch,
                              _unflatten(net.flat.detach().clone(), sizes),
                              vm)
            if vm < best_val:
                best_val, best_flat = vm, net.flat.detach().clone()
    return TrainedModel(params=_unflatten(best_flat, sizes), x_mean=x_mean,
                        x_std=x_std, kind=kind, val_mse=best_val,
                        spec_name=spec_name)


def train_residual_model(feats: np.ndarray, analytical: np.ndarray,
                         rtl: np.ndarray, epochs: int = 400,
                         lr: float = 1e-3, seed: int = 0,
                         **kwargs) -> TrainedModel:
    y = np.log(rtl / analytical)
    return _fit(feats, y, "residual", epochs, lr, seed, **kwargs)


def train_direct_model(feats: np.ndarray, rtl: np.ndarray,
                       epochs: int = 400, lr: float = 1e-3,
                       seed: int = 0, **kwargs) -> TrainedModel:
    return _fit(feats, np.log(rtl), "direct", epochs, lr, seed, **kwargs)


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """Fractional ranks with ties sharing the average of the positions
    they span (standard Spearman tie handling)."""
    x = np.asarray(x)
    order = np.argsort(x, kind="stable")
    pos = np.empty(len(x))
    pos[order] = np.arange(len(x), dtype=float)
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    sums = np.bincount(inv, weights=pos)
    return sums[inv] / counts[inv]


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (paper's Fig. 10/11 metric), with
    average-rank tie handling."""
    ra = _average_ranks(a)
    rb = _average_ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0
