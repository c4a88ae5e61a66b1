"""Pareto-as-a-service: design recommendation over campaign archives (port
of ``repro.launch.recommend``).

A campaign ends with a reconciled archive of Pareto-optimal designs per
(workload, node, mode) cell.  This module answers design queries from it:

* a **query** is a workload (zoo arch name, or a raw feature vector of
  ``repro_torch.workload.features``) + process node + optimization mode +
  optional power/throughput budgets, TTFT cap and PPA weights;
* the **answer** is the best known design.  In-grid queries (an arch whose
  cell the index holds, with an archived point inside the budgets) are
  answered EXACTLY, host-side: the served design is bitwise the cell
  archive's scalarized ``select()`` winner.  The rest fall back to the
  index surrogate, fitted on the recommender's device at build time to
  every measured (workload, node, design) -> (power, perf, area) pair.

Every surrogate fallback of a ``recommend_batch`` call shares ONE
``score_query_batch`` call (``Recommender.n_dispatches`` counts them), and
the candidate matrix is uploaded to the device once, at construction.

CLI::

    python -m repro_torch.launch.recommend --root <campaign> \\
        [--root <more>] --node 5 --mode high_perf [--arch llama3.1-8b] \\
        [--power-budget MW] [--device cuda|cpu]

omitting ``--arch`` answers for every workload in the index; ``--batch``
reads one JSON query per line; ``--serve`` starts the HTTP server
(``repro_torch.launch.serve.recommend_server``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.campaign.planner import (DEFAULT_DTYPE, DEFAULT_PHASE,
                                          MODES, scenario_suffix)
from repro_torch.campaign.store import CampaignStore
from repro_torch.configs import get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.pareto import ArchiveEntry, ParetoArchive
from repro_torch.ppa import surrogate as sur_mod
from repro_torch.ppa.analytic import node_vector
from repro_torch.ppa.nodes import NODES, node_params
from repro_torch.workload.extract import DTYPES, PHASES, extract
from repro_torch.workload.features import as_feature_vector

# PPA weight profiles per mode (paper §5.4; the env's, so that the served
# answer reproduces the campaign's own final selection)
MODE_WEIGHTS = {"high_perf": (0.4, 0.4, 0.2), "low_power": (0.2, 0.6, 0.2)}

# scalarization grid over the (w_perf, w_power, w_area) simplex that builds
# the surrogate fallback's candidate pool: each cell's select() winners
# over this grid, deduplicated; both mode profiles are members
POOL_WEIGHTS = ((0.8, 0.1, 0.1), (0.6, 0.3, 0.1), (0.4, 0.4, 0.2),
                (0.33, 0.34, 0.33), (0.2, 0.6, 0.2), (0.1, 0.8, 0.1),
                (0.1, 0.3, 0.6))


def _log1p(v: np.ndarray) -> np.ndarray:
    """Serving feature transform (values span ~9 orders of magnitude),
    applied identically at fit and query time."""
    return np.log1p(np.maximum(np.asarray(v, np.float64), 0.0)
                    ).astype(np.float32)


# the optional scenario suffix's last ``__`` segment: unambiguous against
# arch names containing ``__`` because modes are only high_perf/low_power
_SCENARIO_SEG = re.compile(r"^(native|fp8|int8)-(decode|prefill)$")


def split_scenario(cell_id: str) -> Tuple[str, str, str]:
    """``<base>[__<dtype>-<phase>]`` -> (base_cell_id, dtype, phase);
    default-scenario cells carry no suffix and come back as (cell_id,
    'native', 'decode')."""
    head, _, last = cell_id.rpartition("__")
    m = _SCENARIO_SEG.match(last) if head else None
    if m:
        return head, m.group(1), m.group(2)
    return cell_id, DEFAULT_DTYPE, DEFAULT_PHASE


def split_cell_id(cell_id: str) -> Tuple[str, int, str]:
    """``<arch>__<node>nm__<mode>[__<dtype>-<phase>]`` ->
    (arch, node_nm, mode); :func:`split_scenario` gives the axes."""
    base, _, _ = split_scenario(cell_id)
    arch, node_s, mode = base.rsplit("__", 2)
    return arch, int(node_s[:-2]), mode


@dataclasses.dataclass
class Query:
    """One recommendation request.

    Exactly one of ``arch`` (config-zoo name) or ``features`` (WL_DIM
    vector or field mapping, see ``workload.features.as_feature_vector``)
    identifies the workload.  ``power_budget_mw`` caps power,
    ``min_perf_gops`` floors compute, ``min_tok_s`` floors decode
    throughput and ``max_ttft_ms`` caps a prefill cell's time to first
    token (the last two: archive answers only).  Weights default to the
    mode profile."""
    node_nm: int
    mode: str = "high_perf"
    arch: Optional[str] = None
    features: Optional[np.ndarray] = None
    power_budget_mw: float = math.inf
    min_perf_gops: float = 0.0
    min_tok_s: float = 0.0
    w_perf: Optional[float] = None
    w_power: Optional[float] = None
    w_area: Optional[float] = None
    phase: str = DEFAULT_PHASE
    dtype: str = DEFAULT_DTYPE
    max_ttft_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if (self.arch is None) == (self.features is None):
            raise ValueError("query needs exactly one of arch / features")
        if self.arch is not None and self.arch not in ARCH_IDS:
            raise ValueError(f"unknown arch {self.arch!r}; "
                             f"zoo: {sorted(ARCH_IDS)}")
        if self.features is not None:
            self.features = as_feature_vector(self.features)
        if self.node_nm not in NODES:
            raise ValueError(f"unknown process node {self.node_nm}; "
                             f"known: {NODES}")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; known: {MODES}")
        if not self.power_budget_mw > 0:
            raise ValueError("power_budget_mw must be > 0")
        if self.phase not in PHASES:
            raise ValueError(f"unknown phase {self.phase!r}; "
                             f"known: {list(PHASES)}")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; "
                             f"known: {list(DTYPES)}")
        if self.max_ttft_ms is not None and not self.max_ttft_ms > 0:
            raise ValueError("max_ttft_ms must be > 0")

    @property
    def weights(self) -> Tuple[float, float, float]:
        if self.w_perf is not None:
            return (float(self.w_perf), float(self.w_power or 0.0),
                    float(self.w_area or 0.0))
        return MODE_WEIGHTS[self.mode]

    @classmethod
    def from_dict(cls, d: Dict) -> "Query":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(d) - known)
        if extra:
            raise ValueError(f"unknown query key(s) {extra}; "
                             f"known: {sorted(known)}")
        if "node_nm" not in d:
            raise ValueError("query missing required key 'node_nm'")
        return cls(**d)


@dataclasses.dataclass
class Answer:
    """One recommendation.  ``source`` is ``"archive"`` (exact: the cell
    archive's select winner, metrics as the campaign measured them) or
    ``"surrogate"`` (metrics predicted for this query's workload;
    ``cell_id`` names the cell the design was mined from).
    ``within_budget`` is False when the budgets excluded every candidate
    and the answer is best-effort."""
    source: str
    cell_id: Optional[str]
    cfg: np.ndarray
    power_mw: float
    perf_gops: float
    area_mm2: float
    tok_s: Optional[float] = None
    ppa_score: Optional[float] = None
    within_budget: bool = True

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["cfg"] = np.asarray(self.cfg, np.float64).tolist()
        return d


@dataclasses.dataclass
class _Candidate:
    cell_id: str
    entry: ArchiveEntry


class ArchiveIndex:
    """Merged archive index over one or more campaign run directories.

    ``cells`` maps cell_id -> dominance-filtered :class:`ParetoArchive`
    (the union across roots, ``CampaignStore.archive_index``);
    ``candidates`` is the surrogate fallback's pool: each cell's
    ``select()`` winners over ``POOL_WEIGHTS``, deduplicated, with the
    cell they came from.  Pure host numpy, as in the reference."""

    def __init__(self, cells: Dict[str, ParetoArchive],
                 seq_len: int, batch: int):
        self.cells = {cid: ar for cid, ar in cells.items() if len(ar)}
        self.seq_len = seq_len
        self.batch = batch
        self.candidates: List[_Candidate] = []
        seen = set()
        for cid in sorted(self.cells):
            ar = self.cells[cid]
            for w in POOL_WEIGHTS:
                e = ar.select(*w)
                k = tuple(np.asarray(e.cfg, np.float64).round(6).tolist())
                if k not in seen:
                    seen.add(k)
                    self.candidates.append(_Candidate(cid, e))
        if not self.candidates:
            raise ValueError(
                "archive index holds no frontier points; run (and "
                "reconcile) a campaign first")
        # keyed on the full extraction settings: multi-root indexes and
        # scenario cells must not alias
        self._wl_cache: Dict[Tuple[str, int, int, str, str],
                             np.ndarray] = {}
        self._node_cache: Dict[Tuple[int, str], np.ndarray] = {}

    @classmethod
    def build(cls, roots: Sequence[str]) -> "ArchiveIndex":
        if not roots:
            raise ValueError("at least one campaign run directory required")
        primary = CampaignStore.open(roots[0])
        merged = primary.archive_index(list(roots[1:]))
        spec = primary.manifest.get("spec") or {}
        return cls(merged, seq_len=int(spec.get("seq_len", 2048)),
                   batch=int(spec.get("batch", 3)))

    def wl_features(self, arch: str, phase: str = DEFAULT_PHASE,
                    dtype: str = DEFAULT_DTYPE) -> np.ndarray:
        """Workload features of a zoo arch at the index's extraction
        settings (cached: extraction walks the operator graph)."""
        key = (arch, self.seq_len, self.batch, phase, dtype)
        if key not in self._wl_cache:
            self._wl_cache[key] = extract(
                get_config(arch), seq_len=self.seq_len,
                batch=self.batch, phase=phase, dtype=dtype).features
        return self._wl_cache[key]

    def node_ctx(self, node_nm: int, mode: str) -> np.ndarray:
        """(NODE_DIM,) log1p node half of the serving context (cached)."""
        key = (node_nm, mode)
        if key not in self._node_cache:
            nv = node_vector(
                node_params(node_nm, low_power=mode != "high_perf"),
                high_perf=mode == "high_perf")
            self._node_cache[key] = _log1p(nv)
        return self._node_cache[key]

    def query_context(self, features: np.ndarray, node_nm: int,
                      mode: str) -> np.ndarray:
        """(WL_DIM + NODE_DIM,) log1p serving context of one query."""
        return np.concatenate([_log1p(features),
                               self.node_ctx(node_nm, mode)])

    def training_set(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every measured (context || design) -> log1p(power, perf, area)
        pair of every frontier entry of every cell (a design archived
        under two nodes is two rows), each cell's context at its own phase
        and dtype."""
        xs, ys = [], []
        for cid in sorted(self.cells):
            arch, node_nm, mode = split_cell_id(cid)
            _, dt, ph = split_scenario(cid)
            ctx = self.query_context(self.wl_features(arch, ph, dt),
                                     node_nm, mode)
            for e in self.cells[cid].entries:
                xs.append(np.concatenate([ctx, _log1p(e.cfg)]))
                ys.append(np.log1p(np.maximum(
                    [e.power_mw, e.perf_gops, e.area_mm2], 0.0)))
        return (np.asarray(xs, np.float32), np.asarray(ys, np.float32))

    def cand_matrix(self) -> np.ndarray:
        """(C, cs.DIM) log1p design vectors of the candidate pool."""
        return np.stack([_log1p(c.entry.cfg) for c in self.candidates])


class Recommender:
    """Answers design queries from an :class:`ArchiveIndex` on ``device``.

    The index surrogate is fitted there at construction (``params``
    replaces its seeded init; with ``fit_steps=0`` it is used as given)
    and the candidate matrix uploaded once.  Exact in-grid answers are
    host-side archive lookups; every surrogate fallback of a
    ``recommend_batch`` call shares ONE ``score_query_batch`` call
    (``n_dispatches`` counts them)."""

    def __init__(self, index: ArchiveIndex, *, fit_steps: int = 400,
                 seed: int = 0, device="cuda",
                 params: Optional[Dict] = None):
        self.index = index
        self.device = device_mod.resolve(device)
        x, y = index.training_set()
        self.surrogate = sur_mod.fit_index_surrogate(
            x, y, steps=fit_steps, seed=seed, device=self.device,
            params=params)
        self._cand = torch.as_tensor(index.cand_matrix(), device=self.device)
        self._cand_cfgs = [c.entry.cfg for c in index.candidates]
        self.n_dispatches = 0
        # lifetime answer provenance (the server's /healthz and /metrics)
        self.n_exact = 0
        self.n_surrogate = 0

    @classmethod
    def build(cls, roots: Sequence[str], **kw) -> "Recommender":
        return cls(ArchiveIndex.build(roots), **kw)

    def _exact(self, q: Query) -> Optional[Answer]:
        """Archive answer for an in-grid query, or None if the query is
        out of grid (unknown cell, or budgets no archived point meets)."""
        if q.arch is None:
            return None
        cid = (f"{q.arch}__{q.node_nm}nm__{q.mode}"
               f"{scenario_suffix(q.dtype, q.phase)}")
        ar = self.index.cells.get(cid)
        if ar is None:
            return None
        min_tok = q.min_tok_s
        if q.max_ttft_ms is not None and q.phase == "prefill":
            # a prefill cell's tok_s is prompt throughput, so a TTFT cap
            # is a floor on it at the index's prompt size
            min_tok = max(min_tok, 1e3 * self.index.seq_len
                          * self.index.batch / q.max_ttft_ms)
        entries = [e for e in ar.entries
                   if e.power_mw <= q.power_budget_mw
                   and e.perf_gops >= q.min_perf_gops
                   and e.tok_s >= min_tok]
        if not entries:
            return None
        if len(entries) == len(ar.entries):
            sub = ar                     # unfiltered: the cell archive
        else:                            # itself, select() verbatim
            sub = ParetoArchive(max_size=ar.max_size)
            sub.entries = entries
        e = sub.select(*q.weights)
        return Answer(source="archive", cell_id=cid, cfg=e.cfg,
                      power_mw=e.power_mw, perf_gops=e.perf_gops,
                      area_mm2=e.area_mm2, tok_s=e.tok_s,
                      ppa_score=e.ppa_score)

    def recommend(self, q: Query) -> Answer:
        return self.recommend_batch([q])[0]

    def recommend_batch(self, queries: Sequence[Query]) -> List[Answer]:
        """Answer a batch: exact lookups host-side, every surrogate
        fallback in one ``score_query_batch`` call on the device."""
        answers: List[Optional[Answer]] = [None] * len(queries)
        pend: List[int] = []
        for i, q in enumerate(queries):
            ans = self._exact(q)
            if ans is not None:
                answers[i] = ans
            else:
                pend.append(i)
        self.n_exact += len(queries) - len(pend)
        self.n_surrogate += len(pend)
        if pend:
            qs = [queries[i] for i in pend]
            feats = np.stack(
                [q.features if q.features is not None
                 else self.index.wl_features(q.arch, q.phase, q.dtype)
                 for q in qs])
            fl = np.log1p(np.maximum(feats, np.float32(0.0)))
            nodes = np.stack([self.index.node_ctx(q.node_nm, q.mode)
                              for q in qs])
            q_arr = np.concatenate([fl, nodes], axis=1)
            wts = np.asarray([q.weights for q in qs], np.float32)
            wts /= np.maximum(wts.sum(axis=1, keepdims=True),
                              np.float32(1e-9))
            to_dev = lambda a: torch.as_tensor(
                np.asarray(a, np.float32), device=self.device)
            idx, pred, within = sur_mod.score_query_batch(
                self.surrogate.params, to_dev(q_arr), self._cand,
                to_dev(wts), to_dev([q.power_budget_mw for q in qs]),
                to_dev([q.min_perf_gops for q in qs]))
            self.n_dispatches += 1
            idx = idx.cpu().tolist()
            preds = pred.cpu().numpy().astype(np.float64).tolist()
            within = within.cpu().tolist()
            cands = self.index.candidates
            for row, i in enumerate(pend):
                j = idx[row]
                p = preds[row]
                answers[i] = Answer(
                    source="surrogate", cell_id=cands[j].cell_id,
                    cfg=self._cand_cfgs[j].copy(),
                    power_mw=p[0], perf_gops=p[1], area_mm2=p[2],
                    within_budget=within[row])
        return answers  # type: ignore[return-value]


# ------------------------------------------------------------------- CLI
def _queries_from_args(a: argparse.Namespace,
                       index: ArchiveIndex) -> List[Query]:
    common = dict(node_nm=a.node, mode=a.mode,
                  power_budget_mw=(a.power_budget if a.power_budget
                                   else math.inf),
                  min_perf_gops=a.min_perf, min_tok_s=a.min_tok_s,
                  phase=a.phase, dtype=a.dtype,
                  max_ttft_ms=a.max_ttft_ms)
    if a.batch:
        out = []
        with open(a.batch) as f:
            for line in f:
                if line.strip():
                    d = json.loads(line)
                    d.setdefault("node_nm", a.node)
                    d.setdefault("mode", a.mode)
                    out.append(Query.from_dict(d))
        return out
    if a.features:
        with open(a.features) as f:
            return [Query(features=json.load(f), **common)]
    archs = ([a.arch] if a.arch else
             sorted({split_cell_id(cid)[0] for cid in index.cells}))
    return [Query(arch=w, **common) for w in archs]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="query the Pareto-as-a-service archive index")
    ap.add_argument("--root", action="append", required=True,
                    help="campaign run directory (repeatable; frontiers "
                         "are unioned with dominance filtering)")
    ap.add_argument("--node", type=int, default=None,
                    help=f"process node in nm; one of {list(NODES)}")
    ap.add_argument("--mode", default="high_perf", choices=list(MODES))
    ap.add_argument("--arch", default=None,
                    help="zoo workload to ask for (default: every "
                         "workload in the index)")
    ap.add_argument("--features", default=None,
                    help="JSON file with a workload feature vector or "
                         "{field: value} mapping (out-of-grid query)")
    ap.add_argument("--batch", default=None,
                    help="file of JSON queries, one per line; all "
                         "surrogate fallbacks share one dispatch")
    ap.add_argument("--power-budget", type=float, default=None,
                    help="max power in mW")
    ap.add_argument("--min-perf", type=float, default=0.0,
                    help="min performance in GOPS")
    ap.add_argument("--min-tok-s", type=float, default=0.0,
                    help="min decode tok/s (archive answers only)")
    ap.add_argument("--phase", default=DEFAULT_PHASE, choices=list(PHASES),
                    help="scenario phase to answer for (suffixed cells)")
    ap.add_argument("--dtype", default=DEFAULT_DTYPE, choices=list(DTYPES),
                    help="scenario datapath dtype to answer for")
    ap.add_argument("--max-ttft-ms", type=float, default=None,
                    help="TTFT SLO cap in ms (prefill-phase archive "
                         "answers only)")
    ap.add_argument("--report", action="store_true",
                    help="also write the archive-index report under the "
                         "primary root's report/ directory")
    ap.add_argument("--serve", action="store_true",
                    help="start the always-on HTTP recommendation server "
                         "instead of answering one query batch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8177)
    ap.add_argument("--device", default="cuda",
                    help="device of the index surrogate (cuda or cpu)")
    a = ap.parse_args(argv)
    if a.arch and a.features:
        ap.error("--arch and --features are mutually exclusive")
    if not a.serve and not a.batch and a.node is None:
        ap.error("--node is required (unless --serve or --batch carries "
                 "per-query nodes)")
    try:
        rec = Recommender.build(a.root, device=a.device)
    except (OSError, ValueError) as e:
        ap.error(str(e))
    if a.serve:
        from repro_torch.launch.serve import recommend_server
        recommend_server(a.root, host=a.host, port=a.port, recommender=rec)
        return
    if a.report:
        from repro_torch.campaign.report import write_index_report
        paths = write_index_report(CampaignStore.open(a.root[0]),
                                   rec.index.cells)
        print(f"[recommend] index report -> {paths['index_json']}",
              file=sys.stderr)
    try:
        queries = _queries_from_args(a, rec.index)
    except (OSError, ValueError) as e:
        ap.error(str(e))
    answers = rec.recommend_batch(queries)
    for q, ans in zip(queries, answers):
        d = ans.to_dict()
        d["query"] = dict(arch=q.arch, node_nm=q.node_nm, mode=q.mode)
        print(json.dumps(d))
    print(f"[recommend] {len(queries)} quer"
          f"{'y' if len(queries) == 1 else 'ies'} answered "
          f"({sum(1 for x in answers if x.source == 'archive')} exact, "
          f"{rec.n_dispatches} surrogate dispatch(es))", file=sys.stderr)


if __name__ == "__main__":
    main()
