"""Prioritized experience replay (paper §3.11; port of
``repro.core.replay``): 100K capacity, proportional prioritization
p_i = (|delta_i| + 1e-6)^0.6, importance-sampling exponent beta annealed
0.4 -> 1.0 at +0.001 per sampled batch.

:class:`PERBuffer` lives on the buffer's device: the transition arrays and
the float64 sum-tree are tensors there, the tree is written through the
``sumtree`` kernel (``kernels.sumtree``) and sampled through the
``sumtree_sample`` descent kernel (``kernels.sumtree_sample``), one thread
per sample.  The tree stays float64, as the reference's
host tree: every node is one float64 addition of its final children, and
the descent compares and subtracts in float64, so for the same uniforms
the port samples the reference's indices.  Host randomness (the uniforms)
is drawn from the buffer's numpy Generator exactly as the reference draws
it.  The host :class:`SumTree` stays here as the oracle.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import to_numpy
from repro_torch.kernels import sumtree as sumtree_kernel
from repro_torch.kernels import sumtree_sample

CAPACITY = 100_000
ALPHA_PER = 0.6
BETA0 = 0.4
BETA_INC = 0.001
EPS_P = 1e-6


class SumTree:
    """Host float64 sum-tree (the reference's, kept as the oracle)."""

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
        affected ancestors bottom-up.  For non-power-of-two capacities the
        leaves straddle two tree levels, so an update band can contain both
        a node and its parent; iterating until the band set is empty
        guarantees every node's LAST recompute sees final children."""
        i = np.asarray(idx, np.int64) + self.capacity
        self.tree[i] = values
        i = np.unique(i // 2)
        i = i[i >= 1]
        while i.size:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i = np.unique(i // 2)
            i = i[i >= 1]


class PERBuffer:
    """Device-resident PER with the reference's semantics for ``add_batch``,
    ``sample``, ``update_priorities``, ``recent``, ``pos``, ``size``,
    ``max_priority`` and ``beta``."""

    FIELDS = ("s", "a_cont", "a_disc", "r", "s2", "done")

    def __init__(self, state_dim: int, cont_dim: int, disc_dim: int,
                 capacity: int = CAPACITY, seed: int = 0, device="cpu"):
        dev = torch.device(device)
        self.capacity = capacity
        self.device = dev
        f32 = dict(dtype=torch.float32, device=dev)
        self.s = torch.zeros((capacity, state_dim), **f32)
        self.a_cont = torch.zeros((capacity, cont_dim), **f32)
        self.a_disc = torch.zeros((capacity, disc_dim), dtype=torch.int32,
                                  device=dev)
        self.r = torch.zeros((capacity,), **f32)
        self.s2 = torch.zeros((capacity, state_dim), **f32)
        self.done = torch.zeros((capacity,), **f32)
        self.tree = torch.zeros((2 * capacity,), dtype=torch.float64,
                                device=dev)
        self.pos = 0
        self.size = 0
        self.max_priority = 1.0
        self.beta = BETA0
        self.rng = np.random.default_rng(seed)

    def add_batch(self, s, a_cont, a_disc, r, s2, done) -> None:
        """Insert B transitions in one shot (equivalent to B sequential
        single adds): rows at ``pos, pos+1, ...`` modulo capacity, leaves at
        the current max priority^alpha."""
        n = len(r)
        idx = (self.pos + torch.arange(n, device=self.device)) \
            % self.capacity
        for name, v in zip(self.FIELDS, (s, a_cont, a_disc, r, s2, done)):
            dst = getattr(self, name)
            dst[idx] = torch.as_tensor(v, device=self.device).to(dst.dtype)
        sumtree_kernel.sumtree_set_many(self.tree, idx,
                                        self.max_priority ** ALPHA_PER)
        self.pos = int((self.pos + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)

    def sample(self, batch: int) -> Tuple[Dict[str, torch.Tensor],
                                          torch.Tensor]:
        """Stochastic prioritized sampling; returns (batch dict of device
        tensors, indices [batch] int64 on the device)."""
        total = self.tree[1]
        u = torch.as_tensor(self.rng.random(batch), device=self.device)
        idx = sumtree_sample.sumtree_sample(self.tree, u, self.size)
        probs = self.tree[idx + self.capacity] / torch.clamp_min(total,
                                                                 1e-12)
        w = (self.size * torch.clamp_min(probs, 1e-12)) ** (-self.beta)
        w = (w / w.max()).to(torch.float32)
        self.beta = min(1.0, self.beta + BETA_INC)
        out = {name: getattr(self, name)[idx] for name in self.FIELDS}
        out["is_w"] = w
        return out, idx

    def update_priorities(self, idx: torch.Tensor, td_abs) -> None:
        """p = (|td| + 1e-6)^0.6, computed on the host in numpy exactly as
        the reference computes it (so ``max_priority`` and the leaves are
        the reference's bits), then written through the sum-tree kernel."""
        td = to_numpy(td_abs) if isinstance(td_abs, torch.Tensor) \
            else np.asarray(td_abs)
        pr = (np.abs(td) + EPS_P) ** ALPHA_PER
        self.max_priority = max(self.max_priority, float(pr.max(initial=0.0)))
        idx = torch.as_tensor(idx, device=self.device).to(torch.int64)
        sumtree_kernel.sumtree_set_many(
            self.tree, idx.contiguous(),
            torch.as_tensor(pr.astype(np.float64), device=self.device))

    def recent(self, n: int) -> Dict[str, torch.Tensor]:
        """Most recent n transitions (world-model training, §3.16)."""
        n = min(n, self.size)
        idx = (self.pos - 1 - torch.arange(n, device=self.device)) \
            % self.capacity
        return dict(s=self.s[idx], a_cont=self.a_cont[idx], s2=self.s2[idx])
