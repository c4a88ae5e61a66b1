"""Prioritized experience replay (paper §3.11): 100K capacity, proportional
prioritization p_i = (|delta_i| + 1e-6)^0.6, importance-sampling exponent
beta annealed 0.4 -> 1.0 at +0.001 per sampled batch.

Sum-tree in numpy for O(log N) sampling; host-side (the SAC update itself
runs on the device).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

CAPACITY = 100_000
ALPHA_PER = 0.6
BETA0 = 0.4
BETA_INC = 0.001
EPS_P = 1e-6


class SumTree:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.zeros(2 * capacity, np.float64)

    def set(self, idx: int, value: float) -> None:
        i = idx + self.capacity
        self.tree[i] = value
        i //= 2
        while i >= 1:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i //= 2

    def total(self) -> float:
        return float(self.tree[1])

    def sample(self, u: float) -> int:
        """Find leaf index with prefix-sum >= u."""
        i = 1
        while i < self.capacity:
            left = self.tree[2 * i]
            if u <= left:
                i = 2 * i
            else:
                u -= left
                i = 2 * i + 1
        return i - self.capacity

    def get(self, idx: int) -> float:
        return float(self.tree[idx + self.capacity])

    def set_many(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Vectorized multi-leaf set: write all leaves, then rebuild the
        affected ancestors bottom-up (O(B log N) numpy, no python per-leaf
        loop).

        For non-power-of-two capacities the leaves straddle two tree levels,
        so an update band can contain both a node and its parent; the parent
        then reads the child's pre-band value.  Iterating until the band set
        is empty (each node's k-th ancestor lands in band k) guarantees every
        node's LAST recompute sees fully updated children."""
        i = np.asarray(idx, np.int64) + self.capacity
        self.tree[i] = values
        i = np.unique(i // 2)
        i = i[i >= 1]
        while i.size:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i = np.unique(i // 2)
            i = i[i >= 1]


class PERBuffer:
    def __init__(self, state_dim: int, cont_dim: int, disc_dim: int,
                 capacity: int = CAPACITY, seed: int = 0):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a_cont = np.zeros((capacity, cont_dim), np.float32)
        self.a_disc = np.zeros((capacity, disc_dim), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.tree = SumTree(capacity)
        self.pos = 0
        self.size = 0
        self.max_priority = 1.0
        self.beta = BETA0
        self.rng = np.random.default_rng(seed)

    def add(self, s, a_cont, a_disc, r, s2, done) -> None:
        i = self.pos
        self.s[i] = s
        self.a_cont[i] = a_cont
        self.a_disc[i] = a_disc
        self.r[i] = r
        self.s2[i] = s2
        self.done[i] = done
        self.tree.set(i, self.max_priority ** ALPHA_PER)
        self.pos = (self.pos + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def add_batch(self, s, a_cont, a_disc, r, s2, done) -> None:
        """Insert B transitions in one shot (vectorized DSE engine path).
        Equivalent to B sequential ``add`` calls."""
        n = len(r)
        idx = (self.pos + np.arange(n)) % self.capacity
        self.s[idx] = s
        self.a_cont[idx] = a_cont
        self.a_disc[idx] = a_disc
        self.r[idx] = r
        self.s2[idx] = s2
        self.done[idx] = done
        self.tree.set_many(idx, self.max_priority ** ALPHA_PER)
        self.pos = int((self.pos + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Stochastic prioritized sampling; returns (batch dict, indices)."""
        total = self.tree.total()
        seg = total / batch
        us = (np.arange(batch) + self.rng.random(batch)) * seg
        idx = np.array([self.tree.sample(float(u)) for u in us], np.int64)
        idx = np.minimum(idx, self.size - 1)
        probs = np.array([self.tree.get(int(i)) for i in idx]) / max(total, 1e-12)
        w = (self.size * np.maximum(probs, 1e-12)) ** (-self.beta)
        w = (w / w.max()).astype(np.float32)
        self.beta = min(1.0, self.beta + BETA_INC)
        out = dict(s=self.s[idx], a_cont=self.a_cont[idx],
                   a_disc=self.a_disc[idx], r=self.r[idx], s2=self.s2[idx],
                   done=self.done[idx], is_w=w)
        return out, idx

    def update_priorities(self, idx: np.ndarray, td_abs: np.ndarray) -> None:
        pr = (np.abs(td_abs) + EPS_P) ** ALPHA_PER
        self.max_priority = max(self.max_priority, float(pr.max(initial=0.0)))
        self.tree.set_many(np.asarray(idx, np.int64), pr)

    def recent(self, n: int) -> Dict[str, np.ndarray]:
        """Most recent n transitions (world-model training, §3.16)."""
        n = min(n, self.size)
        idx = (self.pos - 1 - np.arange(n)) % self.capacity
        return dict(s=self.s[idx], a_cont=self.a_cont[idx], s2=self.s2[idx])
