"""Deterministic, shard-addressable synthetic data pipeline (copy of
``repro.data.pipeline``: it imports no JAX, but the port keeps its own).

Every (step, shard) cell of the stream is a pure function of the seed —
any host can (re)compute any shard, which is the property the fault-
tolerance story relies on (straggler re-assignment and bit-exact resume
after preemption, DESIGN.md §5).

Two generators:
  * ``lcg_stream``: learnable sequences — next token is an affine function
    of the previous token with occasional noise, so small models visibly
    reduce loss within a few hundred steps (used by examples/train_smollm).
  * ``uniform_stream``: i.i.d. tokens (throughput benchmarking).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lcg"         # 'lcg' | 'uniform'
    noise: float = 0.05
    n_shards: int = 1
    shard: int = 0


def _rng_for(dc: DataConfig, step: int, shard: int) -> np.random.Generator:
    # stable, collision-free key per (seed, step, shard)
    return np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, shard, 0xA5EED]))


def batch_at(dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch for `step`, restricted to this config's shard."""
    assert dc.global_batch % dc.n_shards == 0
    local = dc.global_batch // dc.n_shards
    rng = _rng_for(dc, step, dc.shard)
    if dc.kind == "uniform":
        toks = rng.integers(0, dc.vocab, (local, dc.seq_len + 1), np.int32)
    else:
        a = 31 % dc.vocab or 1
        c = 7
        start = rng.integers(0, dc.vocab, (local, 1), np.int32)
        seq = [start]
        for _ in range(dc.seq_len):
            nxt = (seq[-1] * a + c) % dc.vocab
            seq.append(nxt.astype(np.int32))
        toks = np.concatenate(seq, axis=1)
        flip = rng.random((local, dc.seq_len + 1)) < dc.noise
        toks = np.where(flip, rng.integers(0, dc.vocab, toks.shape), toks)
    return dict(tokens=toks[:, :-1].astype(np.int32),
                labels=toks[:, 1:].astype(np.int32))


def stream(dc: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(dc, step)
        step += 1
