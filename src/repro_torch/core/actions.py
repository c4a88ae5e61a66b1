"""Action space — paper Table 3 (port of ``repro.core.actions``): 30
continuous dims + 4 discrete mesh/SC deltas (5-way categorical each,
{-2,-1,0,+1,+2}).

Continuous dims 0-25 are bounded deltas on design fields 4..29; dims 26-29
are the heterogeneity-spread controls of the post-RL per-TCC derivation.
Policy output is 80-dim: 20 discrete logits + 30 means + 30 log-stds.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import const
from repro_torch.ppa import config_space as cs

N_CONT = 30
N_DISC = 4                 # mesh_w, mesh_h, sc_x, sc_y deltas
N_DISC_OPTIONS = 5         # {-2,-1,0,+1,+2}

DELTA_FRAC = 0.08
_CONT_FIELD_SLICE = slice(4, 4 + 26)
CONT_SCALE = (cs.HI[_CONT_FIELD_SLICE] - cs.LO[_CONT_FIELD_SLICE]) * DELTA_FRAC

DISC_DELTAS = np.array([-2, -1, 0, 1, 2], dtype=np.float32)
_DISC_FIELDS = np.array([cs.IDX["mesh_w"], cs.IDX["mesh_h"], cs.IDX["sc_x"],
                         cs.IDX["sc_y"]], np.int64)


def apply_action(cfg: np.ndarray, a_cont: np.ndarray, a_disc: np.ndarray
                 ) -> np.ndarray:
    """Apply one action to a design vector (the scalar engine's host
    path); returns the projected new vector.

    a_cont: [30] in [-1,1];  a_disc: [4] integer category ids in [0,5).
    """
    new = np.array(cfg, dtype=np.float32, copy=True)
    new[4:30] += np.asarray(a_cont[:26], np.float32) * CONT_SCALE
    for j, f in enumerate(_DISC_FIELDS):
        new[f] += DISC_DELTAS[int(a_disc[j])]
    return cs.project(torch.as_tensor(new)).numpy()


def cont_delta(a_cont: np.ndarray) -> np.ndarray:
    """Host-side continuous design deltas: (B, 30) actions -> (B, 26).

    Kept in numpy, as in the reference: the product is rounded on its own
    before the device add, so no fused multiply-add can move a quantised
    field by one ulp."""
    return np.asarray(a_cont[:, :26], np.float32) * CONT_SCALE


def apply_action_vec(cfg: torch.Tensor, delta_cont: torch.Tensor,
                     a_disc: torch.Tensor) -> torch.Tensor:
    """cfg (B, 30) float32; delta_cont (B, 26) from :func:`cont_delta`;
    a_disc (B, 4) int category ids in [0,5) -> projected new cfg."""
    new = cfg.clone()
    new[:, _CONT_FIELD_SLICE] += delta_cont
    deltas = const(DISC_DELTAS, cfg.device)[a_disc.long()]
    new[:, const(_DISC_FIELDS, cfg.device)] += deltas
    return cs.project(new)


def random_action_batch(rng: np.random.Generator, batch: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch of uniform exploration actions (same numpy draws as the
    reference)."""
    a_c = rng.uniform(-1.0, 1.0, size=(batch, N_CONT)).astype(np.float32)
    a_d = rng.integers(0, N_DISC_OPTIONS, size=(batch, N_DISC)).astype(np.int32)
    return a_c, a_d


def random_action(rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    a_c = rng.uniform(-1.0, 1.0, size=N_CONT).astype(np.float32)
    a_d = rng.integers(0, N_DISC_OPTIONS, size=N_DISC).astype(np.int32)
    return a_c, a_d
