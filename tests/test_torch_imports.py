"""The port imports neither JAX nor anything of the JAX package: every
``repro_torch`` module and ``chip_smoke.py`` import in a fresh interpreter
where ``import jax`` fails, and no ``repro`` module is loaded afterwards.
Importing builds no kernel."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, os, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(sys.argv[1], "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k, m in sys.modules.items() if m is not None and (
    k == "repro" or k.startswith("repro.") or k.split(".")[0] == "jax"))
print("MODULES", len(names))
print("BAD", bad)
"""


def test_port_imports_without_jax_or_reference():
    build_dir = os.path.join(ROOT, "src", "repro_torch", "kernels", "_build")
    existed = os.path.isdir(build_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 25
    assert lines["BAD"] == "[]"
    assert os.path.isdir(build_dir) == existed
