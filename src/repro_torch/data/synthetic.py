"""Deterministic synthetic LM data (``repro/data/synthetic.py``).

Driven by numpy alone, so for the same (seed, step) it yields the same
batches as the JAX package.  Each worker's shard comes from a
worker-specific token marginal (heterogeneity > 0 skews the per-worker
vocabulary slice), so the per-worker gradients genuinely differ -- the
setting where EF-BV's control variates matter.  Sequences have local bigram
structure (token t+1 = 3 t + noise + offset mod V).

``resample_from_shard`` switches to the stochastic-gradient regime: each
worker owns a fixed finite shard and every round resamples its minibatch
from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    n_workers: int = 1
    seed: int = 0
    heterogeneity: float = 0.5  # 0 = iid workers, 1 = disjoint vocab slices
    # federated stochastic-gradient regime: each worker holds a FIXED local
    # shard of shard_size sequences (its finite-sum f_i) and every round
    # resamples its minibatch from that shard, instead of streaming fresh
    # sequences (the exact-local-objective regime above).
    resample_from_shard: bool = False
    shard_size: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # per-worker vocab offsets create heterogeneous token marginals
        self._offsets = rng.integers(0, self.vocab, size=self.n_workers)
        self._mult = 6364136223846793005 % self.vocab
        if self.resample_from_shard:
            shard_rng = np.random.default_rng((self.seed, 0x5A3D))
            self._shards = [self._gen_rows(shard_rng, w, self.shard_size)
                            for w in range(self.n_workers)]

    def _gen_rows(self, rng, w: int, count: int) -> np.ndarray:
        """``count`` bigram-structured sequences from worker w's marginal."""
        S, V = self.seq_len, self.vocab
        span = max(int(V * (1.0 - self.heterogeneity)), V // 16)
        base = rng.integers(0, span, size=(count, 1))
        start = (base + self._offsets[w]) % V
        noise = rng.integers(0, 7, size=(count, S))
        seqs = np.zeros((count, S), np.int64)
        seqs[:, 0] = start[:, 0]
        for t in range(1, S):
            seqs[:, t] = (seqs[:, t - 1] * 3 + noise[:, t] + self._offsets[w]) % V
        return seqs

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for one step: tokens + next-token labels.

        Streaming mode draws fresh per-worker sequences; shard-resampling
        mode draws per_w uniform (with replacement) rows from each worker's
        fixed shard -- both deterministic in (seed, step).
        """
        B, S = self.global_batch, self.seq_len
        per_w = B // self.n_workers
        rng = np.random.default_rng((self.seed, step))
        rows = []
        for w in range(self.n_workers):
            if self.resample_from_shard:
                idx = rng.integers(0, self.shard_size, size=per_w)
                rows.append(self._shards[w][idx])
            else:
                rows.append(self._gen_rows(rng, w, per_w))
        tokens = np.concatenate(rows, 0).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        labels[:, -1] = -1  # no loss on the wrap position
        return {"tokens": tokens, "labels": labels}
