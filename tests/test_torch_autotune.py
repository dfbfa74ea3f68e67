"""The port's matmul autotuner and kernel wrapper against the reference:
`round_block`, `tune_matmul_blocks` and `default_blocks` (blocks equal),
the (bm, bk, bn) `tuned_matmul` hands the kernel wrapper (equal), and
the wrapper's CPU path — the plain version — on the kernel tests'
shapes against the reference's `matmul_ref` (f32 1e-4, bf16 2e-2, the
tolerances of tests/test_kernels.py).  The CUDA kernel itself runs only
on the card; `chip_smoke.py` holds it against its plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as R_tune
from repro.kernels.matmul import ops as R_ops
from repro.kernels.matmul.ref import matmul_ref as R_matmul_ref
from repro_torch.core import autotune as T_tune
from repro_torch.kernels.matmul import matmul as T_matmul_mod
from repro_torch.kernels.matmul.ops import tuned_blocks, tuned_matmul

MM_SHAPES = [(128, 128, 128), (256, 512, 384), (64, 1024, 256),
             (512, 64, 128)]                        # (m, k, n)
# (m, n, k) problems the kernels' wrappers tune: the kernel tests' shapes,
# tests/test_kernels.py's tuned wrapper, and the Qwen3-0.6B FFN
# up-projection at 4096 tokens.
TUNE_SHAPES = [(m, n, k) for (m, k, n) in MM_SHAPES] + [
    (256, 512, 768), (4096, 3072, 1024)]


def test_round_block_equal():
    rng = np.random.default_rng(0)
    for dim in (1, 7, 64, 96, 768, 1000, 4096):
        for target in rng.uniform(0.5, 2 * dim, 20):
            assert T_tune.round_block(dim, target) == \
                R_tune.round_block(dim, target)


@pytest.mark.parametrize("shape", TUNE_SHAPES, ids=str)
def test_tuned_blocks_equal(shape, monkeypatch):
    """`tune_matmul_blocks` (blocks, history, latency), `default_blocks`
    and the (bm, bk, bn) `tuned_matmul` passes on, all equal to the
    reference's, from one reference tuning run per shape."""
    m, n, k = shape
    runs = []
    tune = R_tune.tune_matmul_blocks

    def recording(*args, **kwargs):
        runs.append(tune(*args, **kwargs))
        return runs[-1]
    monkeypatch.setattr(R_tune, "tune_matmul_blocks", recording)
    ref_blocks = R_tune.default_blocks.__wrapped__(m, n, k)  # uncached
    (ref,) = runs
    got = T_tune.tune_matmul_blocks(m, n, k, steps=120, device="cpu")
    assert got.blocks == ref.blocks == ref_blocks
    assert got.history == ref.history
    assert got.latency_s == ref.latency_s
    assert T_tune.default_blocks(m, n, k, device="cpu") == ref_blocks

    seen = {}

    def spy(x, y, *, bm, bk, bn, interpret):
        seen.update(bm=bm, bk=bk, bn=bn)
    monkeypatch.setattr(R_ops, "matmul", spy)
    R_ops.tuned_matmul(jnp.zeros((m, k)), jnp.zeros((k, n)),
                       blocks=ref_blocks)
    assert tuned_blocks(m, k, n, device="cpu") == \
        (seen["bm"], seen["bk"], seen["bn"])


@pytest.mark.parametrize("shape", MM_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_cpu_path_matches_reference(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * 31 + n)
    x = rng.standard_normal((m, k), dtype=np.float32)
    y = rng.standard_normal((k, n), dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(R_matmul_ref(jnp.asarray(x, jdt), jnp.asarray(y, jdt)),
                     dtype=np.float32)
    before = T_matmul_mod.matmul.launches
    by_variant = dict(T_matmul_mod.matmul.launches_by_variant)
    got = tuned_matmul(torch.tensor(x).to(tdt), torch.tensor(y).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    assert T_matmul_mod.matmul.launches == before   # no kernel on the CPU
    assert T_matmul_mod.matmul.launches_by_variant == by_variant
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)


def test_matmul_wrapper_checks():
    x = torch.zeros((64, 96))
    y = torch.zeros((96, 32))
    with pytest.raises(ValueError, match="must divide"):
        T_matmul_mod.matmul(x, y, bm=48, bk=96, bn=32)
    with pytest.raises(ValueError, match="inner dims"):
        T_matmul_mod.matmul(x, torch.zeros((95, 32)))
    with pytest.raises(TypeError):
        T_matmul_mod.matmul(x.double(), y.double())
    with pytest.raises(ValueError, match="contiguous"):
        T_matmul_mod.matmul(x, torch.zeros((32, 96)).t())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.core.problem import Layer, Workload
    from repro_torch.core.search import SearchConfig, dosa_search
    wl = Workload(layers=(Layer.matmul(64, 64, 64),))
    with pytest.raises(RuntimeError, match="cuda"):
        dosa_search(wl, SearchConfig(steps=1, round_every=1,
                                     n_start_points=1))
    with pytest.raises(RuntimeError, match="cuda"):
        T_tune.default_blocks(128, 128, 128)
    with pytest.raises(RuntimeError, match="cuda"):
        T_tune.tune_matmul_blocks(128, 128, 128, steps=1)
