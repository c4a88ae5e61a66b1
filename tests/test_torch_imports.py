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
print("NAMES", ",".join(names))
"""

# the modules each slice added, which must be among those imported
PORTED = ("repro_torch.checkpoint.manager", "repro_torch.core.fsutil",
          "repro_torch.core.replay", "repro_torch.kernels.sumtree",
          "repro_torch.kernels.sumtree_sample",
          "repro_torch.kernels.policy_mlp", "repro_torch.campaign.planner",
          "repro_torch.campaign.store", "repro_torch.campaign.report",
          "repro_torch.campaign.runner", "repro_torch.launch.dse",
          "repro_torch.configs.jamba_v0_1_52b", "repro_torch.models.layers",
          "repro_torch.models.attention", "repro_torch.models.blocks",
          "repro_torch.models.lm", "repro_torch.launch.serve",
          "repro_torch.kernels.flash_attention",
          "repro_torch.kernels.ssm_scan", "repro_torch.obs",
          "repro_torch.obs.trace", "repro_torch.obs.metrics",
          "repro_torch.obs.log", "repro_torch.obs.export",
          "repro_torch.distributed.sharding",
          "repro_torch.campaign.distrib", "repro_torch.launch.fleet",
          "repro_torch.launch.recommend", "repro_torch.models.cost_model",
          "repro_torch.campaign.transfer", "repro_torch.data.pipeline",
          "repro_torch.optim.trainer", "repro_torch.launch.train",
          *(f"repro_torch.configs.{m}" for m in (
              "smollm_135m", "qwen1_5_110b", "qwen2_72b", "mixtral_8x7b",
              "llama4_maverick_400b_a17b", "minicpm3_4b",
              "llama_3_2_vision_90b", "whisper_medium", "xlstm_1_3b")))


def test_port_imports_without_jax_or_reference():
    build_dir = os.path.join(ROOT, "src", "repro_torch", "kernels", "_build")
    existed = os.path.isdir(build_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 50
    assert set(PORTED) <= set(lines["NAMES"].split(","))
    assert lines["BAD"] == "[]"
    assert os.path.isdir(build_dir) == existed
