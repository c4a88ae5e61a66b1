"""The harness on the card at the miniature cells: runs through the
kernels agree with the reference, the traced run reads the device's
timeline (busy time, kernel time by name, the blocks' spans), and the
float8 control fails the limits there too.  Marked ``cuda``: they skip
without a card (``python -m pytest -q -m cuda perfbench/tests``)."""
import json
import time

import pytest

from conftest import TINY, TINY_TRAFFIC, make_root
from benchlib import check, runner
from test_perfbench_harness import control_numbers

CELLS = [f"{m}.{t}" for m in sorted(TINY) for t in sorted(TINY_TRAFFIC)]
SEED = 2**31 + 303


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_cell_on_the_card(tmp_path, cuda_device, cell):
    root = make_root(tmp_path, "float32")
    res = runner.run_cell(cell, SEED, 2.0, True, dev=cuda_device,
                          t_process=time.perf_counter(), root=root)
    res.pop("extra")
    json.dumps(res)
    assert res["correct"], res["check"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    m = res["metrics"]
    for name, v in m.items():
        if name.endswith("roofline") or name.startswith("mfu"):
            assert 0 < v["value"] <= 105, (name, v)
    assert any(n.startswith("moe_ms") for n in m)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(tmp_path, cuda_device, cell):
    nums, lim = control_numbers(make_root(tmp_path), cell, cuda_device)
    assert not check.verdict(nums["control"], lim)["ok"], nums
