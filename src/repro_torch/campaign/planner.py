"""Campaign planner: grid spec -> cells -> mixed-node cell batches (port of
``repro.campaign.planner``).

A campaign cell is one (workload, process node, optimization mode) search.
Cells sharing (workload, mode) are packed into mixed-node batches: node
constants enter the ``VecDSEEnv`` step as per-env vectors, so every cell in
a batch shares one env step and one SAC policy / PER buffer (see
``repro_torch.core.search.run_search_cells``).

The spec keeps every field of the reference's, so either package reads the
other's manifests.  Scenario axes (``dtypes``, ``phases``) multiply the
grid, with the default scenario's batches first; ``slo`` turns on
SLO-aware selection; ``devices`` and ``hosts`` are validated as the
reference validates them; ``transfer_from`` names donor run directories
(``repro_torch.campaign.transfer``) and ``priorities`` orders the batches'
execution.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ARCH_IDS
from repro_torch.ppa.nodes import NODES
from repro_torch.ppa.surrogate import TAU_SUR_DEFAULT
from repro_torch.workload.extract import DTYPES, PHASES

MODES = ("high_perf", "low_power")
# default scenario point: ids/keys carry NO suffix here, so campaign
# directories, checkpoints and fingerprints match the reference's
DEFAULT_DTYPE = "native"
DEFAULT_PHASE = "decode"


def scenario_suffix(dtype: str, phase: str) -> str:
    """``"__{dtype}-{phase}"`` for non-default scenarios, ``""`` at the
    default."""
    if dtype == DEFAULT_DTYPE and phase == DEFAULT_PHASE:
        return ""
    return f"__{dtype}-{phase}"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (workload, node, mode[, dtype, phase]) point of the grid."""
    arch: str
    node_nm: int
    mode: str                    # 'high_perf' | 'low_power'
    dtype: str = DEFAULT_DTYPE
    phase: str = DEFAULT_PHASE

    @property
    def cell_id(self) -> str:
        return (f"{self.arch}__{self.node_nm}nm__{self.mode}"
                f"{scenario_suffix(self.dtype, self.phase)}")

    @property
    def high_perf(self) -> bool:
        return self.mode == "high_perf"


@dataclasses.dataclass(frozen=True)
class CellBatch:
    """Cells that run as one mixed-node ``run_search_cells`` invocation.
    All cells share (arch, mode, dtype, phase); ``batch_id`` keys
    checkpoints."""
    index: int
    arch: str
    mode: str
    node_nms: tuple
    dtype: str = DEFAULT_DTYPE
    phase: str = DEFAULT_PHASE

    @property
    def key(self) -> str:
        """Index-free content key (arch, mode, nodes, scenario)."""
        nodes = "-".join(str(n) for n in self.node_nms)
        return (f"{self.arch}__{self.mode}__{nodes}nm"
                f"{scenario_suffix(self.dtype, self.phase)}")

    @property
    def batch_id(self) -> str:
        return f"b{self.index:03d}__{self.key}"

    @property
    def cells(self) -> List[Cell]:
        return [Cell(self.arch, n, self.mode, self.dtype, self.phase)
                for n in self.node_nms]


@dataclasses.dataclass
class CampaignSpec:
    """Grid + budget of one campaign (the ``--campaign grid.json`` payload).

    ``episodes`` is the per-cell env-step budget; ``lanes`` the parallel
    environments per cell; ``max_envs`` caps the total batch B =
    n_cells_in_batch * lanes of one mixed-node dispatch.
    """
    name: str
    workloads: List[str]
    nodes: List[int] = dataclasses.field(default_factory=lambda: list(NODES))
    modes: List[str] = dataclasses.field(default_factory=lambda: list(MODES))
    episodes: int = 512
    lanes: int = 8
    max_envs: int = 64
    seed: int = 0
    seq_len: int = 2048
    batch: int = 3               # decode batch fed to workload extraction
    checkpoint_every: int = 8    # dispatches between search checkpoints
    surrogate_gate: bool = True
    screen_k: int = 4
    gate_threshold: float = TAU_SUR_DEFAULT
    # fleet launch hint: hosts for the remote worker launcher (slot i runs
    # on hosts[i % len(hosts)]).  Purely a launch concern — two specs that
    # differ only in hosts search identically.
    hosts: Optional[List[str]] = None
    # chunk each dispatch's env batch over this many devices (None = the
    # plain single-device step).  Purely an execution-layout concern: the
    # chunked step is bitwise the unchunked one, so two specs that differ
    # only in devices search identically.
    devices: Optional[int] = None
    # cross-campaign transfer (repro_torch.campaign.transfer): donor run
    # directories whose archives and weights warm-start this campaign's
    # batches and train its cost model; recorded in the manifest so the
    # fleet deal and --resume derive the same plan
    transfer_from: Optional[List[str]] = None
    # predicted cost per CellBatch.key (transfer.with_transfer fills it):
    # plan() runs batches by descending cost; batch indices, and with
    # them the per-batch seeds, stay in spec order
    priorities: Optional[Dict[str, float]] = None
    dtypes: List[str] = dataclasses.field(
        default_factory=lambda: [DEFAULT_DTYPE])
    phases: List[str] = dataclasses.field(
        default_factory=lambda: [DEFAULT_PHASE])
    # serving SLO targets: None disables SLO-aware selection; a flat
    # {"ttft_ms": .., "tok_s": ..} applies to every mode; a per-mode
    # {"high_perf": {...}, "low_power": {...}} overrides per mode
    # (missing keys fall back to repro_torch.core.reward.DEFAULT_SLOS).
    slo: Optional[Dict] = None

    def __post_init__(self) -> None:
        unknown = [w for w in self.workloads if w not in ARCH_IDS]
        if unknown:
            raise ValueError(f"unknown workloads {unknown}; "
                             f"ported zoo: {sorted(ARCH_IDS)}")
        bad = [n for n in self.nodes if n not in NODES]
        if bad:
            raise ValueError(f"unknown process nodes {bad}; known: {NODES}")
        bad_modes = [m for m in self.modes if m not in MODES]
        if bad_modes:
            raise ValueError(f"unknown modes {bad_modes}; known: {MODES}")
        if self.lanes < 1 or self.episodes < 1:
            raise ValueError("episodes and lanes must be >= 1")
        if self.max_envs < self.lanes:
            raise ValueError(f"max_envs ({self.max_envs}) must be >= lanes "
                             f"({self.lanes})")
        if self.screen_k < 1:
            raise ValueError(f"screen_k must be >= 1 (got {self.screen_k})")
        if self.gate_threshold < 0:
            raise ValueError(f"gate_threshold must be >= 0 "
                             f"(got {self.gate_threshold})")
        if self.hosts is not None and (
                not self.hosts or any(not isinstance(h, str) or not h.strip()
                                      for h in self.hosts)):
            raise ValueError(f"hosts must be a non-empty list of host "
                             f"names (got {self.hosts!r})")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1 (got {self.devices})")
        if self.transfer_from is not None and (
                not isinstance(self.transfer_from, list)
                or not self.transfer_from
                or any(not isinstance(r, str) or not r.strip()
                       for r in self.transfer_from)):
            raise ValueError(f"transfer_from must be a non-empty list of "
                             f"run directories (got {self.transfer_from!r})")
        if self.priorities is not None and (
                not isinstance(self.priorities, dict)
                or any(not isinstance(v, (int, float))
                       or isinstance(v, bool)
                       for v in self.priorities.values())):
            raise ValueError(f"priorities must map batch keys to numbers "
                             f"(got {self.priorities!r})")
        bad_dt = [d for d in self.dtypes if d not in DTYPES]
        if bad_dt or not self.dtypes:
            raise ValueError(f"unknown dtypes {bad_dt or self.dtypes}; "
                             f"known: {list(DTYPES)}")
        bad_ph = [p for p in self.phases if p not in PHASES]
        if bad_ph or not self.phases:
            raise ValueError(f"unknown phases {bad_ph or self.phases}; "
                             f"known: {list(PHASES)}")
        if self.slo is not None:
            if not isinstance(self.slo, dict) or not self.slo:
                raise ValueError(f"slo must be a non-empty dict "
                                 f"(got {self.slo!r})")
            per_mode = all(isinstance(v, dict) for v in self.slo.values())
            groups = self.slo.values() if per_mode else [self.slo]
            if per_mode:
                bad = sorted(set(self.slo) - set(MODES))
                if bad:
                    raise ValueError(f"per-mode slo keys {bad} unknown; "
                                     f"modes: {list(MODES)}")
            for g in groups:
                bad = sorted(set(g) - {"ttft_ms", "tok_s"})
                if bad or any(not isinstance(v, (int, float))
                              or isinstance(v, bool) or v <= 0
                              for v in g.values()):
                    raise ValueError(
                        f"slo targets must be positive numbers keyed "
                        f"'ttft_ms'/'tok_s' (got {g!r})")

    @property
    def n_cells(self) -> int:
        return (len(self.workloads) * len(self.nodes) * len(self.modes)
                * len(self.dtypes) * len(self.phases))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "CampaignSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(d) - known)
        if extra:
            import difflib
            hints = []
            for k in extra:
                close = difflib.get_close_matches(k, known, n=1)
                hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                         if close else ""))
            raise ValueError(
                f"unknown campaign spec keys {', '.join(hints)}; "
                f"known keys: {sorted(known)}")
        missing = [f.name for f in dataclasses.fields(cls)
                   if f.default is dataclasses.MISSING
                   and f.default_factory is dataclasses.MISSING
                   and f.name not in d]
        if missing:
            raise ValueError(f"campaign spec missing required "
                             f"key{'s' if len(missing) > 1 else ''} "
                             f"{missing}")
        return cls(**d)

    @classmethod
    def from_file(cls, path: str) -> "CampaignSpec":
        """Load a grid spec from .json or .yaml/.yml."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError as e:   # pragma: no cover
                raise RuntimeError(
                    f"{path}: pyyaml not installed; use a .json grid") from e
            try:
                payload = yaml.safe_load(text)
            except yaml.YAMLError as e:
                raise ValueError(f"invalid YAML: {e}") from e
            return cls.from_dict(payload)
        return cls.from_dict(json.loads(text))


def cells(spec: CampaignSpec) -> List[Cell]:
    """Expand the grid: workloads (outer) x dtypes x phases x modes x
    nodes (inner).  With the default single-point scenario axes this is
    exactly the expansion without them."""
    return [Cell(w, n, m, dt, ph)
            for w in spec.workloads for dt in spec.dtypes
            for ph in spec.phases for m in spec.modes for n in spec.nodes]


def plan(spec: CampaignSpec) -> List[CellBatch]:
    """Pack the grid into mixed-node batches of <= max_envs environments.

    Grouping key is (workload, dtype, phase, mode) — those fix the env's
    workload vector and reward weights — and the node list is chunked so
    that ``len(chunk) * lanes <= max_envs``.  Batch ``index`` (and with it
    the per-batch seed ``spec.seed + 1000 * index``) follows spec order, so
    with the default dtype and phase listed first the default scenario's
    batches come first and keep the seeds of a grid without scenario axes.

    With ``spec.priorities`` (predicted cost per ``CellBatch.key``) the
    list is ordered by descending cost, ties by ``batch_id``; ``index`` is
    still assigned in spec order, so the per-batch seeds, and with them
    every fingerprint, are the unprioritised plan's.
    """
    per_batch = max(1, spec.max_envs // spec.lanes)
    out: List[CellBatch] = []
    for w in spec.workloads:
        for dt in spec.dtypes:
            for ph in spec.phases:
                for m in spec.modes:
                    nodes: Sequence[int] = spec.nodes
                    for i in range(0, len(nodes), per_batch):
                        out.append(CellBatch(
                            index=len(out), arch=w, mode=m,
                            node_nms=tuple(nodes[i:i + per_batch]),
                            dtype=dt, phase=ph))
    if spec.priorities:
        pr = spec.priorities
        out = sorted(out, key=lambda b: (-float(pr.get(b.key, 0.0)),
                                         b.batch_id))
    return out


_PLAN_CACHE: Dict[str, List[CellBatch]] = {}
_PLAN_CACHE_MAX = 32


def plan_cached(spec: CampaignSpec) -> List[CellBatch]:
    """``plan`` memoized per spec (keyed on its canonical dict).  The
    batches are frozen dataclasses, so one shared list per spec is safe;
    callers must not mutate the returned list."""
    key = json.dumps(spec.to_dict(), sort_keys=True)
    batches = _PLAN_CACHE.get(key)
    if batches is None:
        while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        batches = _PLAN_CACHE[key] = plan(spec)
    return batches
