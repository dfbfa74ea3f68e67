"""Black-box DSE baselines (paper Sec. 6.1/6.3).

The PyTorch port's own copy of the reference module
(`repro.core.baselines`): host numpy in both packages, so for a seed
the port gives the reference's best EDP and history exactly
(`tests/test_torch_baselines.py`).  Neither baseline touches a device.

* `random_search` — the paper's random baseline: `n_hw` random hardware
  designs, `n_map` random mappings per layer per design, evaluated with
  the oracle (the Timeloop stand-in).

* `bayes_opt` — the paper's two-loop Bayesian-optimization baseline
  (hyperparameters after Spotlight [38]): observe `n_hw` hardware
  designs each scored by the best of `n_map` random mappings per layer,
  fit a Gaussian-process regressor over log-hardware features, then pick
  the best-predicted of `n_candidates` candidate designs and evaluate it.

Both count every oracle evaluation as one sample and return
(best_edp, history) with history = [(cumulative evals, best so far)].
"""
from __future__ import annotations

import numpy as np

from .arch import GemminiHW
from .hw_infer import random_hw
from .mapping import random_mapping
from .oracle import evaluate
from .problem import Workload


def _best_mappings_for_hw(workload: Workload, hw: GemminiHW,
                          n_map: int, rng: np.random.Generator):
    """Per-layer best-EDP random mapping under `hw`; returns
    (network_edp, evals_used)."""
    e_tot, l_tot, evals = 0.0, 0.0, 0
    for layer in workload.layers:
        best_e, best_l, best_edp = None, None, float("inf")
        dims = np.asarray(layer.dims)
        for _ in range(n_map):
            m = random_mapping(dims, rng, max_pe_dim=hw.pe_dim)
            r = evaluate(m, layer, hw=hw)
            evals += 1
            if r.valid and r.edp < best_edp:
                best_edp, best_e, best_l = r.edp, r.energy, r.latency
        if best_e is None:
            return float("inf"), evals
        e_tot += best_e * layer.repeat
        l_tot += best_l * layer.repeat
    return e_tot * l_tot, evals


def random_search(workload: Workload, n_hw: int = 10, n_map: int = 1000,
                  seed: int = 0):
    rng = np.random.default_rng(seed)
    best, evals, history = float("inf"), 0, []
    for _ in range(n_hw):
        hw = random_hw(rng)
        edp, used = _best_mappings_for_hw(workload, hw, n_map, rng)
        evals += used
        best = min(best, edp)
        history.append((evals, best))
    return best, history


# ---------------------------------------------------------------------------
# Gaussian-process BO
# ---------------------------------------------------------------------------

def _hw_features(hw: GemminiHW) -> np.ndarray:
    return np.log(np.array([hw.pe_dim, hw.acc_kb, hw.sp_kb]))


class _GP:
    """Minimal RBF-kernel GP regressor (numpy Cholesky)."""

    def __init__(self, lengthscale: float = 1.0, noise: float = 1e-2):
        self.ls, self.noise = lengthscale, noise

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray):
        self.x, self.y_mean = x, y.mean()
        kxx = self._k(x, x) + self.noise * np.eye(len(x))
        self.l_chol = np.linalg.cholesky(kxx)
        self.alpha = np.linalg.solve(
            self.l_chol.T, np.linalg.solve(self.l_chol, y - self.y_mean))
        return self

    def predict(self, xq: np.ndarray) -> np.ndarray:
        return self._k(xq, self.x) @ self.alpha + self.y_mean


def bayes_opt(workload: Workload, n_hw: int = 100, n_map: int = 100,
              n_candidates: int = 1000, final_map: int = 1000,
              seed: int = 0):
    rng = np.random.default_rng(seed)
    xs, ys, history = [], [], []
    best, evals = float("inf"), 0
    for _ in range(n_hw):
        hw = random_hw(rng)
        edp, used = _best_mappings_for_hw(workload, hw, n_map, rng)
        evals += used
        if np.isfinite(edp):
            xs.append(_hw_features(hw))
            ys.append(np.log(edp))
        best = min(best, edp)
        history.append((evals, best))
    gp = _GP().fit(np.asarray(xs), np.asarray(ys))
    cands = [random_hw(rng) for _ in range(n_candidates)]
    preds = gp.predict(np.stack([_hw_features(h) for h in cands]))
    chosen = cands[int(np.argmin(preds))]
    edp, used = _best_mappings_for_hw(workload, chosen, final_map, rng)
    evals += used
    best = min(best, edp)
    history.append((evals, best))
    return best, history
