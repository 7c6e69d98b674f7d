"""Deterministic, restartable data pipelines, the port's copy of
``repro.data.pipeline`` (numpy only, so the batches are the reference's,
bit for bit, for each (seed, step)).

* determinism -- batch t is a pure function of (seed, step): a restart
  never replays or skips data;
* skip-ahead -- resuming at step N needs no O(N) scan;
* host-sharding -- each host materialises only its slice of the global
  batch (by host index);
* synthetic sources for the paper's tasks (KWS MFCC-like frames, VWW-like
  images) and LM token streams, so everything runs offline. The
  classification tasks are learnable (class-conditional patterns + noise).

Batches are numpy arrays; the training loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    kind: str  # "lm" | "kws" | "vww"
    global_batch: int
    seq_len: int = 0  # lm
    vocab: int = 0  # lm
    n_classes: int = 12  # kws/vww
    input_hw: tuple = (49, 10)
    channels: int = 1
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count


def _rng_for(cfg: PipelineConfig, step: int) -> np.random.Generator:
    # counter-based: O(1) skip-ahead, host-disjoint streams
    return np.random.default_rng(
        np.random.SeedSequence(entropy=cfg.seed, spawn_key=(cfg.host_index, step))
    )


def lm_batch(cfg: PipelineConfig, step: int) -> dict:
    """Synthetic token stream with local n-gram structure (learnable)."""
    rng = _rng_for(cfg, step)
    b, s, v = cfg.local_batch, cfg.seq_len, cfg.vocab
    # Markov-ish stream: next token = (3 * prev + noise) mod vocab
    toks = np.empty((b, s + 1), np.int32)
    toks[:, 0] = rng.integers(0, v, b)
    noise = rng.integers(0, 7, (b, s))
    for t in range(1, s + 1):
        toks[:, t] = (3 * toks[:, t - 1] + noise[:, t - 1]) % v
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _class_patterns(cfg: PipelineConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 777)
    h, w = cfg.input_hw
    return rng.normal(0, 1, (cfg.n_classes, h, w, cfg.channels)).astype(np.float32)


def vision_batch(cfg: PipelineConfig, step: int, snr: float = 1.0) -> dict:
    """Class-conditional pattern + Gaussian noise (KWS MFCC / VWW style)."""
    rng = _rng_for(cfg, step)
    pats = _class_patterns(cfg)
    y = rng.integers(0, cfg.n_classes, cfg.local_batch)
    h, w = cfg.input_hw
    x = pats[y] * snr + rng.normal(
        0, 1, (cfg.local_batch, h, w, cfg.channels)
    ).astype(np.float32)
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def batch_at(cfg: PipelineConfig, step: int) -> dict:
    if cfg.kind == "lm":
        return lm_batch(cfg, step)
    return vision_batch(cfg, step)


def iterate(cfg: PipelineConfig, start_step: int = 0) -> Iterator[dict]:
    """Infinite batch iterator with O(1) resume at ``start_step``."""
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
