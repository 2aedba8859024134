"""Deterministic, shardable data pipeline; the port's copy of
``repro/data/pipeline.py`` (numpy only, so batches are bit-identical to the
reference's for every ``(seed, step, shard)``).  The trainer turns them into
tensors at its edge.

Requirements served here:
  * bitwise-deterministic batches as a function of (seed, step, shard) —
    restart/elastic-resume safe: no iterator state to checkpoint beyond the
    step counter;
  * host-sharded loading: each data-parallel host materializes only its
    slice of the global batch;
  * a *learnable* synthetic stream (fixed random Markov chain over the
    vocab) so end-to-end training examples show a real, falling loss with a
    known entropy floor;
  * optional file-backed token store (np.memmap) with identical semantics;
  * straggler hooks: ``reassign(shard, to_shard)`` lets the runtime move a
    slow host's work (see runtime.trainer.StragglerMonitor).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    branching: int = 4          # Markov out-degree: entropy floor = ln(branching)
    token_file: str | None = None


class TokenPipeline:
    """batch_at(step, shard) → {"tokens", "labels"} (numpy, host-local)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide num_shards")
        self.shard_batch = cfg.global_batch // cfg.num_shards
        self._reassignment: dict[int, int] = {}
        rng = np.random.default_rng(cfg.seed ^ 0xC0FFEE)
        # Fixed Markov transition table: each token has `branching` successors
        # with Zipf-ish probabilities -> entropy floor ~ sum p ln 1/p.
        self.successors = rng.integers(0, cfg.vocab, size=(cfg.vocab, cfg.branching))
        raw = 1.0 / np.arange(1, cfg.branching + 1)
        self.trans_p = raw / raw.sum()
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
        else:
            self._mm = None

    @property
    def entropy_floor(self) -> float:
        """Per-token CE floor of the synthetic stream (nats)."""
        return float(-(self.trans_p * np.log(self.trans_p)).sum())

    def reassign(self, shard: int, to_shard: int) -> None:
        """Straggler mitigation: shard's work is generated by to_shard too."""
        self._reassignment[shard] = to_shard

    def effective_shard(self, shard: int) -> int:
        return self._reassignment.get(shard, shard)

    def batch_at(self, step: int, shard: int = 0) -> dict[str, np.ndarray]:
        shard = self.effective_shard(shard)
        cfg = self.cfg
        if self._mm is not None:
            return self._file_batch(step, shard)
        # one independent stream per (step, shard, row)
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard])
        )
        B, S = self.shard_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=B)
        choices = rng.choice(cfg.branching, size=(B, S), p=self.trans_p)
        for t in range(S):
            toks[:, t + 1] = self.successors[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _file_batch(self, step: int, shard: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = self.shard_batch, cfg.seq_len
        n_tokens = self._mm.shape[0]
        span = S + 1
        n_windows = n_tokens // span
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard]))
        idx = rng.integers(0, n_windows, size=B)
        rows = np.stack([self._mm[i * span : (i + 1) * span] for i in idx])
        return {"tokens": rows[:, :-1].astype(np.int32), "labels": rows[:, 1:].astype(np.int32)}

    def global_batch_at(self, step: int) -> dict[str, np.ndarray]:
        """All shards concatenated (single-process testing / pjit feeding)."""
        parts = [self.batch_at(step, s) for s in range(self.cfg.num_shards)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
