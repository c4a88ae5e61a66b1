"""The published-Jamba cell in a checkout in miniature: the real harness,
metrics, reference (``reference/jamba.py``), counts and limits of
``jamba.prefill-mooncake`` on a configuration small enough for the CPU
(the port's ``ai21_jamba2_mini.reduced()``: two periods, attention at
slot 4 with no positions, dt rank 8 with the inner norms, 4 experts whose
top-2 probabilities are the gates).  A sound run is correct, a traced run
reads the Mamba span and the MoE's, and the float8 control fails the
cell's limits where the bf16 program passes them."""
import dataclasses
import json
import time

import pytest
import torch

from conftest import BENCH, ROOT, TINY_TRAFFIC
from benchlib import check, runner
from reference import jamba as ref
from repro_torch.obs import metrics

CPU = torch.device("cpu")
SEED = 2**31 + 303
CELL = "jamba.prefill-mooncake"
CONFIG = "jamba2-mini-pp2"


def _as_run(dtype: str) -> dict:
    from repro_torch.configs import ai21_jamba2_mini
    from repro_torch.models import blocks, lm
    cfg = ai21_jamba2_mini.reduced()
    c = dataclasses.asdict(cfg)
    c["param_dtype"] = dtype
    c["period"] = [dict(kind=k, moe=m) for k, m in lm._layout(cfg)[2]]
    c["moe_dispatch"] = dict(dropless_max_tokens=512, group_tokens=8192,
                             capacity_factor=blocks.MOE_CAPACITY)
    return c


def make_root(tmp, dtype: str):
    """A checkout with the real cell's entries, its configuration's
    ``as_run`` cut to the reduced published Jamba."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    conf["as_run"] = _as_run(dtype)
    for d in ("configs", "traffic", "limits"):
        (tmp / "perfbench" / d).mkdir(parents=True)
    (tmp / "perfbench" / "configs" / f"{CONFIG}.json").write_text(
        json.dumps(conf))
    (tmp / "perfbench" / "traffic" / "prefill-mooncake.json").write_text(
        json.dumps(TINY_TRAFFIC["prefill-mooncake"]))
    (tmp / "perfbench" / "limits" / f"{CELL}.json").write_text(
        (BENCH / "limits" / f"{CELL}.json").read_text())
    bench = dict(real, configs=[c for c in real["configs"]
                                if c["name"] == CONFIG],
                 workloads=[w for w in real["workloads"] if w["name"] == CELL])
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def _run(root, trace=False):
    torch.manual_seed(0)
    res = runner.run_cell(CELL, SEED, 1.0, trace, dev=CPU,
                          t_process=time.perf_counter(), root=root)
    res.pop("extra")
    json.dumps(res)
    return res


def test_sound_run_is_correct(tmp_path):
    res = _run(make_root(tmp_path, "float32"))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "prefill_tok_s", "ttft_ms.p90"}


def test_traced_run_reads_the_mamba_and_moe_spans(tmp_path):
    reg = metrics.global_registry()
    reg.clear()
    res = _run(make_root(tmp_path, "float32"), trace=True)
    assert res["correct"]
    got = res["metrics"]
    # on the CPU the profiler sees no device and there are no peaks: the
    # metrics of device operations (the kernels' rooflines, moe_ms) and
    # the MFU read nothing; the program's spans time the host there (the
    # dispatch only where a prompt of over 512 tokens came in the window)
    want = {"mamba_ms.prefill", "moe_dropped_share.prefill",
            "idle_share.prefill"}
    assert want <= set(got) <= want | {"moe_dispatch_ms.prefill"}
    n = metrics.snapshot_value(reg.snapshot(), "counters",
                               "lm_requests_total")
    assert got["mamba_ms.prefill"]["samples"] == n == res["setup"]["requests"]
    assert got["mamba_ms.prefill"]["value"] > 0


def test_control_fails_the_limits(tmp_path):
    """The program's and the float8 control's numbers over the first three
    requests of the schedule (a fixed sample), against the cell's limits."""
    import itertools
    from benchlib import cells, model, traffic
    from repro_torch.launch import serve
    from repro_torch.models import lm
    root = make_root(tmp_path, "bfloat16")
    bench = cells.benchmark(root)
    c = cells.config(bench, CONFIG, root)["as_run"]
    tr = cells.traffic("prefill-mooncake", root)
    cfg = model.arch_config(c)
    params = model.make_weights(ref.leaf_specs(c), SEED, CPU)
    served = []
    for i, shape in enumerate(itertools.islice(traffic.schedule(tr, SEED),
                                               3)):
        prompts = traffic.prompts(shape, c["vocab"], SEED, i, CPU)
        g = serve.generate(params, cfg, prompts, shape.gen_tokens)
        pos = check.positions(shape.prompt_len, tr["check"]["positions"],
                              SEED, i)
        with torch.no_grad():
            full = lm.forward(params, cfg, prompts)
        served.append(check.Served(prompts, g.tokens, pos,
                                   full[:, pos].clone()))
    nums = check.numbers(ref, params, c, served, [0, 1, 2], control=True)
    lim = cells.limits(CELL, root)
    assert check.verdict(nums["program"], lim)["ok"], nums
    assert not check.verdict(nums["control"], lim)["ok"], nums


def test_scan_roofline_counts_the_exponentials():
    """At the cell's mean prompt the scan's exponentials over the SFU rate
    (the float32 peak over 16) outlast its bytes over the HBM bandwidth,
    and the least time is theirs."""
    from types import SimpleNamespace
    from benchlib import cells, peaks
    from counts import jamba as counts
    c = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    c = c["as_run"]
    pk = peaks.peaks("NVIDIA H100 80GB HBM3")
    D, N = c["mamba"]["expand"] * c["d_model"], c["mamba"]["d_state"]
    w = counts.ssm_scan_call(1, 7573, D, N)
    assert w["exps"] == 7573 * D * N
    by_exp = w["exps"] / (pk["fp32_flops"] / 16)
    assert by_exp > w["bytes"] / pk["hbm_bytes"] > w["flops"] / pk[
        "fp32_flops"]
    t = 0.02
    run = SimpleNamespace(
        trace={"op_device_s": {"ssm_scan_kernel<16>": t, "other": 1.0}},
        peaks=pk, c=c, counts=counts,
        requests=[SimpleNamespace(shape=SimpleNamespace(batch=1,
                                                        prompt_len=7573))])
    got = cells.reader("ssm_scan.roofline")(run)
    assert counts.n_mamba_layers(c) == 14
    assert got == pytest.approx(100.0 * 14 * by_exp / t, rel=1e-12)


def test_mamba_ms_reads_nothing_once_the_mixers_decode():
    """The span totals carry no phase: the prefill reading is given only
    while no token went through a mixer in decode."""
    from benchlib import cells
    read = cells.reader("mamba_ms.prefill")
    reg = metrics.global_registry()
    reg.clear()
    try:
        assert read(None) is None
        reg.counter("lm_requests_total").inc(2)
        reg.counter("lm_span_device_seconds_total",
                    {"span": "mamba"}).inc(0.5)
        reg.counter("lm_mamba_tokens_total", {"phase": "prefill"}).inc(9)
        assert read(None) == dict(value=250.0, samples=2)
        reg.counter("lm_mamba_tokens_total", {"phase": "decode"}).inc(3)
        assert read(None) is None
    finally:
        reg.clear()
