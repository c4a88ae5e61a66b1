"""The readers of the program's own spans and counters in the miniature
checkout: a traced run of each cell reports the metrics that read the
serving spans (``repro_torch.obs``), and the dropped share is the
registry's dropped count over its assignments."""
import time

import pytest
import torch

from conftest import TINY, TINY_TRAFFIC
from benchlib import runner
from repro_torch.obs import metrics

CPU = torch.device("cpu")
SEED = 2**31 + 707
NEW = {"prefill-mooncake": {"moe_dispatch_ms.prefill",
                            "moe_dropped_share.prefill"},
       "chat-sharegpt": {"moe_gather_ms.decode", "decode_host_ms"}}
CELLS = [f"{m}.{t}" for m in sorted(TINY) for t in sorted(TINY_TRAFFIC)]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(tiny_root, cell):
    traffic = cell.split(".", 1)[1]
    reg = metrics.global_registry()
    reg.clear()
    res = runner.run_cell(cell, SEED, 1.0, True, dev=CPU,
                          t_process=time.perf_counter(), root=tiny_root)
    res.pop("extra")
    got = res["metrics"]
    assert NEW[traffic] <= set(got), sorted(got)
    for name in NEW[traffic]:
        assert got[name]["value"] >= 0 and got[name]["samples"] >= 1
    snap = reg.snapshot()
    if traffic == "prefill-mooncake":
        lb = {"phase": "prefill"}
        n = metrics.snapshot_value(snap, "counters",
                                   "lm_moe_assignments_total", lb)
        dropped = metrics.snapshot_value(snap, "counters",
                                         "lm_moe_dropped_total", lb)
        share = got["moe_dropped_share.prefill"]["value"]
        assert 0 <= share <= 100
        assert share == pytest.approx(100.0 * dropped / n, rel=1e-12)
    else:
        steps = metrics.snapshot_value(snap, "counters",
                                       "lm_decode_steps_total")
        assert steps == sum(TINY_TRAFFIC[traffic]["gen_tokens"] - 1
                            for _ in range(res["setup"]["requests"]))
