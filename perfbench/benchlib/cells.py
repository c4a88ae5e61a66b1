"""Finding a cell's files by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration, whose entry of
``configs`` names its file; that file names its plain reference (with the
layout of its weights) under ``reference`` and its work counts under
``counts``, paths of modules under ``perfbench/``.  The cell's traffic mix
is ``traffic/<traffic>.json``, which names its loop
(``loops/<loop>.py``: set-up, window and comparison of one kind of
traffic); its correctness limits are ``limits/<cell>.json``, and each
metric is ``metrics/<metric>.py``, a module with ``read(run)`` that
returns a number or None.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]       # perfbench/
ROOT = BENCH.parent                               # the checkout


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> Dict:
    return load_json(root / "perfbench" / "traffic" / f"{name}.json")


def limits(cell_name: str, root: Path = ROOT) -> Dict:
    return load_json(root / "perfbench" / "limits" / f"{cell_name}.json")


def metrics_for(bench: Dict, cell_name: str, traced: bool) -> List[Dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced):
    those that list the cell under ``workloads``, or list no cells."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def module(path: str):
    """The module at ``path``, relative to ``perfbench/`` (which is on
    ``sys.path``), such as a configuration's ``reference/lm.py``."""
    p = Path(path)
    if p.is_absolute() or ".." in p.parts or p.suffix != ".py":
        raise ValueError(f"{path!r}: a .py file under perfbench/")
    return importlib.import_module(".".join(p.with_suffix("").parts))


def loop(tr: Dict):
    """The loop module of traffic mix ``tr``."""
    return module(f"loops/{tr['loop']}.py")


def reader(metric_name: str):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed and the
    stream's names (any seed, however large, gives distinct streams)."""
    text = "/".join([str(int(seed))] + [str(n) for n in names])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & ((1 << 63) - 1)
