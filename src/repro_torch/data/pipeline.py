"""Federated data pipeline (paper §VI-A partitioning, synthetic sources).

``ClassificationData`` — 10 Gaussian class clusters in 3072-dim space (a
32x32x3 CIFAR-10 stand-in) for the paper-scale FEEL experiments.
``TokenData`` — teacher-bigram token streams for transformer training
(``launch.train``).

Partitioning:
  * IID: shuffle, split into K equal parts.
  * non-IID (pathological, paper §VI-A): sort by label, cut into 2K shards,
    give each device 2 shards (most devices see only 2 classes).

``FederatedBatcher`` realizes the paper's per-device batchsize B_k under
static shapes: each device owns ``slot`` examples of the global batch; a
plan with B_k < slot masks the surplus via per-example weights.

A numpy copy of the reference's pipeline: same rng streams, same draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class ClassificationData:
    x: np.ndarray          # (N, D) float32
    y: np.ndarray          # (N,) int32

    @classmethod
    def synthetic(cls, n: int = 12_000, dim: int = 3072, classes: int = 10,
                  seed: int = 0, spread: float = 4.0):
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(classes, dim)).astype(np.float32) * spread / np.sqrt(dim)
        y = rng.integers(0, classes, size=n).astype(np.int32)
        x = centers[y] + rng.normal(size=(n, dim)).astype(np.float32)
        return cls(x=x, y=y)

    def split(self, n_test: int):
        """Held-out split sharing the same class centers."""
        tr = ClassificationData(self.x[:-n_test], self.y[:-n_test])
        te = ClassificationData(self.x[-n_test:], self.y[-n_test:])
        return tr, te


@dataclass
class TokenData:
    tokens: np.ndarray     # (N, S+1) int32 — input/target windows

    @classmethod
    def synthetic(cls, n: int = 4096, seq: int = 64, vocab: int = 512,
                  seed: int = 0):
        """Markov-chain text: learnable structure, nontrivial loss floor."""
        rng = np.random.default_rng(seed)
        # sparse row-stochastic transition matrix
        trans = rng.dirichlet(np.ones(32), size=vocab)
        nxt = rng.integers(0, vocab, size=(vocab, 32))
        t = np.empty((n, seq + 1), np.int64)
        t[:, 0] = rng.integers(0, vocab, size=n)
        for s in range(seq):
            choice = np.array([rng.choice(32, p=trans[v]) for v in t[:, s]])
            t[:, s + 1] = nxt[t[:, s], choice]
        return cls(tokens=t.astype(np.int32))


def partition_iid(n: int, k: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(idx, k)]


def partition_noniid(labels: np.ndarray, k: int, shards_per_device: int = 2,
                     seed: int = 0) -> List[np.ndarray]:
    """Paper §VI-A: sort by label, 2K shards, 2 shards per device."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, k * shards_per_device)
    assign = rng.permutation(k * shards_per_device)
    return [np.sort(np.concatenate([shards[assign[i * shards_per_device + j]]
                                    for j in range(shards_per_device)]))
            for i in range(k)]


@dataclass
class FederatedBatcher:
    """Fixed-slot batches with per-example weights realizing B_k."""
    parts: List[np.ndarray]       # per-device index sets
    slot: int                     # max examples per device per period (B^max)
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    @property
    def k(self) -> int:
        return len(self.parts)

    def sample(self, batch_per_device: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (indices (K, slot), weights (K, slot)).

        weights[k, i] = 1 for i < B_k else 0; weighted-mean with these
        weights over the flattened batch equals eq. (1)'s
        (1/ΣB_k)·Σ_k B_k·mean-grad_k.
        """
        idx = np.zeros((self.k, self.slot), np.int64)
        w = np.zeros((self.k, self.slot), np.float32)
        for k, part in enumerate(self.parts):
            bk = int(min(batch_per_device[k], self.slot))
            take = self.rng.choice(part, size=self.slot,
                                   replace=len(part) < self.slot)
            idx[k] = take
            w[k, :bk] = 1.0
        return idx, w
