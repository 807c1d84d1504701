"""Deterministic synthetic token pipeline (host-sharded, prefetching).

A copy of the JAX package's ``data/pipeline.py`` (numpy only): the same
(seed, step, row) gives the same tokens bit for bit in both packages.

Production posture without a corpus on disk: a seeded Zipf-ish token
stream, deterministic per (seed, host, step) so (a) restarts resume exactly
(fault tolerance), (b) each data-parallel host reads a DISJOINT shard, and
(c) elastic rescale re-partitions the stream without replaying examples.
A real deployment swaps `_tokens_for` with a tokenized-shard reader; the
iterator contract (per-host batches, ``state_dict``/``load_state_dict``)
stays identical.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class SyntheticLMDataset:
    """Deterministic infinite LM stream.  Batch = {tokens, labels}."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global batch must divide across hosts")
        self.cfg = cfg
        self.step = 0

    # -- determinism / checkpointing -----------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

    def repartition(self, n_hosts: int, host_id: int) -> "SyntheticLMDataset":
        """Elastic rescale: same stream, new host partition, same step."""
        new = SyntheticLMDataset(dataclasses.replace(
            self.cfg, n_hosts=n_hosts, host_id=host_id))
        new.step = self.step
        return new

    # -- batches ----------------------------------------------------------------
    def _tokens_for(self, step: int, row: int) -> np.ndarray:
        """One example row: seeded by (seed, step, global_row) only."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, row]))
        # Zipf-ish marginal over the vocab with short-range repetition
        base = rng.zipf(1.3, size=c.seq_len + 1) % c.vocab_size
        rep = rng.random(c.seq_len + 1) < 0.15
        shifted = np.roll(base, 1)
        return np.where(rep, shifted, base).astype(np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        c = self.cfg
        per_host = c.global_batch // c.n_hosts
        rows = [c.host_id * per_host + r for r in range(per_host)]
        seqs = np.stack([self._tokens_for(step, r) for r in rows])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            batch = self.batch_at(self.step)
            self.step += 1
            yield batch


def make_dataset(vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
    return SyntheticLMDataset(DataConfig(
        vocab_size=vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, n_hosts=n_hosts, host_id=host_id))
