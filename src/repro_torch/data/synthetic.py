"""Deterministic synthetic data: the LM batches of the trainers
(``repro/data/synthetic.py``) and the reference backend's convex problems
(``repro/problems/logreg.py``'s ``make_synthetic`` and :class:`LogReg`, and
the spec's :class:`Quadratic`).

The LM batches:

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
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import random


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


# -----------------------------------------------------------------------------
# the reference backend's convex problems
# -----------------------------------------------------------------------------
#
# Data come from the port's threefry draws, on the device asked for.  The
# uniforms and the normals are JAX's bit for bit (``random.normal`` runs
# XLA's f32 erf_inv), so x_true and Quadratic's b are too.  What still
# differs: torch's ``exp`` of the column scales against XLA's (1 ulp in a
# few columns, so A within 2 ulps), and the matmuls behind the labels and
# Q, so a label whose logit is within that of zero can flip (none does at
# the paper's Figure 2 sizes, pinned by the tests).  Tests that need JAX's
# exact data carry it across as numpy.

def make_synthetic(key, *, N: int, d: int, noise: float = 0.2,
                   scale: float = 1.0, device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LibSVM-like synthetic binary classification data (A (N, d), b (N,)),
    JAX's recipe draw for draw: column scales exp(U(-1.5, 1.5)) spread the
    per-worker smoothness over two decades, labels are the signs of
    A x_true / sqrt(d) with a fraction ``noise`` flipped."""
    k1, k2, k3, k4 = random.split(key, 4)
    col_scales = torch.exp(random.uniform(k1, d, device, minval=-1.5,
                                          maxval=1.5))
    A = random.normal(k2, N * d, device).reshape(N, d) * col_scales * scale
    x_true = random.normal(k3, d, device)
    logits = A @ x_true / math.sqrt(d)
    flip = random.uniform(k4, N, device) < float(np.float32(noise))
    b = torch.where(flip, -torch.sign(logits), torch.sign(logits))
    return A, torch.where(b == 0, 1.0, b)


def _logaddexp0(z: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(z)), stably."""
    return torch.logaddexp(torch.zeros_like(z), z)


@dataclasses.dataclass(frozen=True)
class LogReg:
    """Distributed regularised logistic regression (the paper's Appendix
    C):

        f_i(x) = (1/N_i) sum_j log(1 + exp(-b_ij <a_ij, x>)) + (mu/2)||x||^2
                 (+ lam_nc sum_j x_j^2 / (1 + x_j^2), Appendix C.3)

    with per-worker data (n, Ni, d) already split, and smoothness constants
    L_i = mu + (1/(4 N_i)) sum_j ||a_ij||^2, Ltilde = sqrt(mean L_i^2).
    Gradients are the analytic ones (JAX differentiates the loss): they
    agree with JAX's within f32 rounding."""

    A: torch.Tensor  # (n, Ni, d)
    b: torch.Tensor  # (n, Ni)
    mu_reg: float
    lam_nc: float = 0.0

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[2]

    @staticmethod
    def split(A: torch.Tensor, b: torch.Tensor, n: int, mu_reg: float = 0.1,
              *, overlap: int = 1, key=None, lam_nc: float = 0.0
              ) -> "LogReg":
        """Shuffle (under ``key``, ``random.permutation``) and split into n
        blocks, dropping the remainder; overlap xi gives each worker xi
        consecutive blocks (Appendix C.1)."""
        N, d = A.shape
        if key is not None:
            perm = random.permutation(key, N, A.device).long()
            A, b = A[perm], b[perm]
        Ni = N // n
        blocks_A = A[: Ni * n].reshape(n, Ni, d)
        blocks_b = b[: Ni * n].reshape(n, Ni)
        if overlap == 1:
            return LogReg(blocks_A, blocks_b, mu_reg, lam_nc)
        idx = torch.from_numpy(np.stack(
            [(np.arange(overlap) + i) % n for i in range(n)])).to(A.device)
        return LogReg(blocks_A[idx].reshape(n, overlap * Ni, d),
                      blocks_b[idx].reshape(n, overlap * Ni), mu_reg, lam_nc)

    def L_i(self) -> torch.Tensor:
        return self.mu_reg + (self.A ** 2).sum(dim=(1, 2)) / (
            4.0 * self.A.shape[1])

    def L_tilde(self) -> float:
        return float(torch.sqrt((self.L_i() ** 2).mean()))

    def L_max(self) -> float:
        return float(self.L_i().max())

    def L(self) -> float:
        # the paper sets L = Ltilde in its experiments (Appendix C.1)
        return self.L_tilde()

    def _reg(self, x: torch.Tensor) -> torch.Tensor:
        reg = 0.5 * self.mu_reg * (x * x).sum(dim=-1)
        if self.lam_nc:
            reg = reg + self.lam_nc * (x ** 2 / (1.0 + x ** 2)).sum(dim=-1)
        return reg

    def _reg_grad(self, x: torch.Tensor) -> torch.Tensor:
        g = self.mu_reg * x
        if self.lam_nc:
            g = g + self.lam_nc * 2.0 * x / (1.0 + x ** 2) ** 2
        return g

    def _grads(self, A: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
        """Per-worker gradients of f_i on rows A (n, m, d), labels (n, m)."""
        z = -b * (A @ x)
        coef = -b * torch.sigmoid(z) / A.shape[1]
        return (coef.unsqueeze(1) @ A).squeeze(1) + self._reg_grad(x)

    def f(self, x: torch.Tensor) -> torch.Tensor:
        z = -self.b * (self.A @ x)
        return (_logaddexp0(z).mean(dim=1) + self._reg(x)).mean()

    def grads(self, x: torch.Tensor) -> torch.Tensor:
        """Per-worker gradients, (n, d): what EF-BV compresses."""
        return self._grads(self.A, self.b, x)

    def minibatch_grads(self, key, x: torch.Tensor,
                        batch: int) -> torch.Tensor:
        """Per-worker stochastic gradients, (n, d): worker i draws
        ``randint(split(key, n)[i], batch, 0, Ni)`` rows of its shard (with
        replacement), as JAX's vmap over the split keys does: one row
        draw for all n workers (``random.randint_rows``)."""
        Ni = self.A.shape[1]
        idx = random.randint_rows(random.split(key, self.n), batch, 0, Ni,
                                  x.device).long()
        rows = torch.arange(self.n, device=x.device).unsqueeze(1)
        return self._grads(self.A[rows, idx], self.b[rows, idx], x)

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        return self.grads(x).mean(dim=0)

    def solve(self, steps: int = 4000) -> Tuple[torch.Tensor, float]:
        """f* by plain gradient descent with the 1/L_max stepsize and
        Nesterov momentum, as JAX's ``solve``."""
        gamma = 1.0 / self.L_max()
        x = torch.zeros(self.d, dtype=self.A.dtype, device=self.A.device)
        y, t = x, 1.0
        for _ in range(steps):
            x_new = y - gamma * self.grad(y)
            t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
            y = x_new + (t - 1.0) / t_new * (x_new - x)
            x, t = x_new, t_new
        return x, float(self.f(x))


@dataclasses.dataclass(frozen=True)
class Quadratic:
    """Strongly convex quadratic finite sum f_i(x) = 0.5 x'Q_i x - b_i'x
    (``repro/core/spec.py``'s), Q_i = A_i A_i' + 0.5 I with A_i of
    standard normals / sqrt(d)."""

    Q: torch.Tensor  # (n, d, d)
    b: torch.Tensor  # (n, d)

    @staticmethod
    def make(n: int, d: int, seed: int = 0, device="cuda") -> "Quadratic":
        A = random.normal(random.key(seed), n * d * d, device).reshape(
            n, d, d) / float(np.float32(np.sqrt(d)))
        Q = A @ A.transpose(1, 2) + 0.5 * torch.eye(d, device=A.device)
        b = random.normal(random.key(seed + 1), n * d, device).reshape(n, d)
        return Quadratic(Q=Q, b=b)

    @property
    def n(self) -> int:
        return self.Q.shape[0]

    @property
    def d(self) -> int:
        return self.Q.shape[2]

    def grads(self, x: torch.Tensor) -> torch.Tensor:
        """Per-worker gradients Q_i x - b_i, shape (n, d)."""
        return self.Q @ x - self.b

    def f(self, x: torch.Tensor) -> torch.Tensor:
        quad = 0.5 * ((self.Q @ x) @ x)
        return (quad - self.b @ x).mean()

    def L_i(self) -> torch.Tensor:
        return torch.linalg.eigvalsh(self.Q)[:, -1]

    def L(self) -> float:
        return float(self.L_i().max())

    def L_tilde(self) -> float:
        return float(torch.sqrt((self.L_i() ** 2).mean()))

    def solve(self) -> Tuple[torch.Tensor, float]:
        """Exact minimiser of the average: mean(Q) x* = mean(b)."""
        x_star = torch.linalg.solve(self.Q.mean(dim=0), self.b.mean(dim=0))
        return x_star, float(self.f(x_star))
