"""Pareto archive + scalarized final selection (paper §3.10, §5.4).

Objectives: (power [min], -perf [min], area [min]).  Every feasible
configuration is inserted; the archive maintains the non-dominated frontier.
After convergence the final design is selected by scalarizing frontier-
normalized objectives with the user PPA weights — guaranteeing the returned
configuration is Pareto-optimal among everything explored.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ArchiveEntry:
    cfg: np.ndarray
    power_mw: float
    perf_gops: float
    area_mm2: float
    tok_s: float
    ppa_score: float
    episode: int

    def objectives(self) -> np.ndarray:
        return np.array([self.power_mw, -self.perf_gops, self.area_mm2])

    @classmethod
    def from_metrics(cls, cfg: np.ndarray, metrics: np.ndarray,
                     episode: int) -> "ArchiveEntry":
        """Build an entry from an analytic-PPA metrics vector."""
        from repro_torch.ppa.analytic import M_IDX
        return cls(cfg=np.array(cfg, copy=True),
                   power_mw=float(metrics[M_IDX["power_mw"]]),
                   perf_gops=float(metrics[M_IDX["perf_gops"]]),
                   area_mm2=float(metrics[M_IDX["area_mm2"]]),
                   tok_s=float(metrics[M_IDX["tok_s"]]),
                   ppa_score=float(metrics[M_IDX["ppa_score"]]),
                   episode=episode)

    def to_dict(self) -> Dict:
        """JSON-safe dict; float64 reprs round-trip cfg exactly."""
        d = dataclasses.asdict(self)
        d["cfg"] = np.asarray(self.cfg, np.float64).tolist()
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ArchiveEntry":
        return cls(cfg=np.asarray(d["cfg"], np.float32),
                   power_mw=float(d["power_mw"]),
                   perf_gops=float(d["perf_gops"]),
                   area_mm2=float(d["area_mm2"]), tok_s=float(d["tok_s"]),
                   ppa_score=float(d["ppa_score"]),
                   episode=int(d["episode"]))


def _dominates(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all(a <= b) and np.any(a < b))


class ParetoArchive:
    def __init__(self, max_size: int = 2048):
        self.entries: List[ArchiveEntry] = []
        self.max_size = max_size
        self.n_inserted = 0

    def insert(self, entry: ArchiveEntry) -> bool:
        """Insert if non-dominated; evict newly-dominated entries.

        An entry whose objective vector exactly equals an existing one is
        rejected as a duplicate (the first-seen entry wins): equal vectors
        are mutually non-dominating, so without the check every
        ``merge``/``insert_batch`` of overlapping archives would
        accumulate copies on the frontier — bloating archives and zeroing
        the crowd-prune pairwise distances."""
        self.n_inserted += 1
        obj = entry.objectives()
        keep = []
        for e in self.entries:
            eo = e.objectives()
            if _dominates(eo, obj) or np.array_equal(eo, obj):
                return False          # dominated by (or duplicate of) an
                                      # existing entry
            if not _dominates(obj, eo):
                keep.append(e)
        keep.append(entry)
        if len(keep) > self.max_size:  # crowd-prune: drop densest
            objs = np.stack([e.objectives() for e in keep])
            span = objs.max(0) - objs.min(0) + 1e-9
            normed = (objs - objs.min(0)) / span
            d = np.linalg.norm(normed[:, None] - normed[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            keep.pop(int(np.argmin(d.min(1))))
        self.entries = keep
        return True

    def insert_batch(self, entries: Sequence[ArchiveEntry]) -> int:
        """Insert B entries at once; returns how many reached the frontier.

        Pre-filters the batch to its own non-dominated subset with one
        vectorized pairwise pass (O(B^2) numpy instead of O(B) frontier
        scans for entries a batch-mate already dominates), then runs the
        usual per-entry frontier update.  The resulting archive equals
        sequential insertion (up to crowd-pruning order at max_size).
        """
        if not entries:
            return 0
        objs = np.stack([e.objectives() for e in entries])
        le = np.all(objs[:, None, :] <= objs[None, :, :], axis=-1)
        lt = np.any(objs[:, None, :] < objs[None, :, :], axis=-1)
        dominated = (le & lt).any(axis=0)
        self.n_inserted += int(dominated.sum())
        inserted = 0
        for e, dom in zip(entries, dominated):
            if not dom:
                inserted += int(self.insert(e))
        return inserted

    def select(self, w_perf: float = 0.4, w_power: float = 0.4,
               w_area: float = 0.2) -> Optional[ArchiveEntry]:
        """Scalarized selection on frontier-normalized objectives."""
        if not self.entries:
            return None
        perf = np.array([e.perf_gops for e in self.entries])
        power = np.array([e.power_mw for e in self.entries])
        area = np.array([e.area_mm2 for e in self.entries])

        def norm(x):
            return (x - x.min()) / max(x.max() - x.min(), 1e-9)

        score = (w_perf * (1.0 - norm(perf)) + w_power * norm(power)
                 + w_area * norm(area))
        return self.entries[int(np.argmin(score))]

    def to_dict(self) -> Dict:
        """JSON-ready snapshot of the full archive state."""
        return dict(max_size=self.max_size, n_inserted=self.n_inserted,
                    entries=[e.to_dict() for e in self.entries])

    @classmethod
    def from_dict(cls, d: Dict) -> "ParetoArchive":
        """Exact inverse of :meth:`to_dict` — entries are restored verbatim
        (no re-insertion), so a save→load round trip preserves the frontier
        bit-for-bit including entry order."""
        ar = cls(max_size=int(d.get("max_size", 2048)))
        ar.entries = [ArchiveEntry.from_dict(e) for e in d.get("entries", [])]
        ar.n_inserted = int(d.get("n_inserted", len(ar.entries)))
        return ar

    def merge(self, other: "ParetoArchive") -> int:
        """Union another archive's frontier into this one with dominance
        filtering (the campaign-store merge across resumed/parallel runs);
        returns how many of ``other``'s entries reached the frontier."""
        return self.insert_batch([dataclasses.replace(e, cfg=e.cfg.copy())
                                  for e in other.entries])

    def frontier(self) -> Dict[str, np.ndarray]:
        return dict(
            power_mw=np.array([e.power_mw for e in self.entries]),
            perf_gops=np.array([e.perf_gops for e in self.entries]),
            area_mm2=np.array([e.area_mm2 for e in self.entries]),
            tok_s=np.array([e.tok_s for e in self.entries]),
        )

    def __len__(self) -> int:
        return len(self.entries)
