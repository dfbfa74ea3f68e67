"""Deterministic synthetic data pipeline.

Stateless-by-step: batch t is a pure function of (seed, step), so

  * restart/resume is exact (the checkpoint stores only `step`),
  * straggler skip-and-log is safe (skipping a step never desyncs
    hosts),
  * every host can independently materialize its shard of the global
    batch (host-sharded loading at scale).

Token streams are Zipf-distributed over the vocabulary with
document-boundary resets — enough structure for a loss to fall during
the example runs.

The PyTorch port's own copy of `repro.data.pipeline`, numpy only: the
same (seed, step, host) gives byte-identical arrays in both packages.
The training loop moves a batch to its device."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    modality: str = "text"
    d_model: int = 0              # for audio/vlm embedding stubs
    n_image_tokens: int = 0


def _rng_for(cfg: DataConfig, step: int, host: int = 0):
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def make_batch(cfg: DataConfig, step: int, host: int = 0,
               n_hosts: int = 1) -> dict:
    """Host `host`'s shard of global batch `step`."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    b = cfg.global_batch // n_hosts
    rng = _rng_for(cfg, step, host)
    if cfg.modality == "audio":
        frames = rng.normal(size=(b, cfg.seq_len, cfg.d_model)) \
            .astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (b, cfg.seq_len)) \
            .astype(np.int32)
        return {"frames": frames, "labels": labels}
    # Zipf tokens with doc boundaries
    ranks = rng.zipf(1.3, size=(b, cfg.seq_len)).astype(np.int64)
    tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int32)
    doc_starts = rng.random((b, cfg.seq_len)) < 1.0 / 512
    tokens = np.where(doc_starts, 0, tokens).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.modality == "vision+text":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def make_batch_rows(cfg: DataConfig, step: int, start: int,
                    stop: int) -> dict:
    """Rows [start, stop) of global batch `step` (`make_batch` with one
    host): a rank of a training mesh builds its own rows of the same
    batch that one device trains on, so a sharded run and an unsharded
    one see the same data.  (`make_batch`'s host shards are draws of
    their own, not rows of the one-host batch.)"""
    return {k: v[start:stop] for k, v in make_batch(cfg, step).items()}


def data_config_for(arch: ArchConfig, shape: ShapeConfig,
                    seed: int = 0) -> DataConfig:
    return DataConfig(seed=seed, vocab_size=arch.vocab_size,
                      seq_len=shape.seq_len,
                      global_batch=shape.global_batch,
                      modality=arch.modality, d_model=arch.d_model,
                      n_image_tokens=arch.n_image_tokens)
