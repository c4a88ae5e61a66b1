"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

What is particular to the cell comes from the files it names: the
configuration (its ``as_run``, its reference module with the weights'
layout, its work counts), the traffic mix and its loop (warm-up, the
window, the comparison), the limits and the metric readers.
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from benchlib import cells, check, model, peaks, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    c: Dict                         # the configuration's as_run
    counts: Any                     # the configuration's work counts
    requests: List[Any]             # the loop's completed requests
    t_start: float                  # the window's start
    t_end: float                    # the last completion
    setup_s: float
    peaks: Optional[Dict]
    trace: Optional[Dict] = None
    experts_routed: Optional[List[int]] = None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(dev: torch.device) -> Dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, power_limit_w=None)
    q = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    try:
        power = float(q)
    except ValueError:
        power = None
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=1, power_limit_w=power)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             dev: torch.device, t_process: float, root=cells.ROOT,
             control: bool = False, warm: bool = True) -> Dict:
    """One run; returns the result line's dict (with ``extra`` holding
    what tools read: served requests, the weights).  ``control`` also
    reads the float8 control's numbers; ``warm=False`` skips the warm-up
    (for readings of the numbers compared, which no time enters)."""
    bench = cells.benchmark(root)
    cell = cells.cell(bench, name)
    conf = cells.config(bench, cell["config"], root)
    c = conf["as_run"]
    ref, counts = cells.module(conf["reference"]), cells.module(conf["counts"])
    tr = cells.traffic(cell["traffic"], root)
    loop = cells.loop(tr)
    lim = cells.limits(name, root)
    times = {}
    t = time.perf_counter()
    from repro_torch.launch import serve  # noqa: F401  (the program)
    times["import_s"] = time.perf_counter() - t
    cfg = model.arch_config(c)
    t = time.perf_counter()
    info = device_info(dev)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    times["device_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.library()
    times["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params = model.make_weights(ref.leaf_specs(c), seed, dev)
    _sync(dev)
    times["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if warm:
        loop.warm_up(params, cfg, tr, seed, dev)
    times["warm_up_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_process
    times["other_s"] = setup_s - sum(times.values())

    spans = None
    if trace:
        spans = tracing.Spans()
        prof = tracing.profiler()
        with prof, spans, tracing.window_span():
            requests, served, failed, t0, t1 = loop.window(
                params, cfg, tr, seed, seconds, dev)
            _sync(dev)
        t = time.perf_counter()
        trace_info = tracing.read(prof)
        del prof
        times_trace = time.perf_counter() - t
    else:
        requests, served, failed, t0, t1 = loop.window(params, cfg, tr, seed,
                                                       seconds, dev)
        trace_info, times_trace = None, 0.0
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    pk = peaks.peaks(info["kind"])
    run = Run(c=c, counts=counts, requests=requests, t_start=t0, t_end=t1,
              setup_s=setup_s, peaks=pk, trace=trace_info,
              experts_routed=spans.experts_routed() if spans else None)
    metrics = {}
    for m in cells.metrics_for(bench, name, trace):
        v = cells.reader(m["name"])(run)
        if v is None:
            continue
        v = dict(v) if isinstance(v, dict) else dict(value=v)
        if v["value"] is not None:
            metrics[m["name"]] = dict(v, value=float(v["value"]),
                                      unit=m["unit"])

    # the comparison, after the window, with the program's state freed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    both = loop.compare(ref, params, c, served, seed, tr, control)
    nums = both["program"]
    v = check.verdict(nums, lim)
    check_s = time.perf_counter() - t
    correct = bool(v["ok"] and requests and failed == 0)

    device = dict(platform=info["platform"], kind=info["kind"],
                  count=info["count"], memory_peak_bytes=int(peak),
                  power_limit_w=info["power_limit_w"])
    if trace_info is not None:
        device.update(busy_s=trace_info["busy_s"],
                      window_s=trace_info["window_s"])
    result = dict(correct=correct, attempted=len(requests) + failed,
                  failed=failed, metrics=metrics, device=device)
    if trace_info is not None:
        result["breakdown"] = dict(device_ops=trace_info["device_ops"],
                                   idle_gaps=trace_info["idle_gaps"])
    result["setup"] = dict(times, setup_s=setup_s, check_s=check_s,
                           trace_read_s=times_trace,
                           requests=len(requests),
                           window_s=t1 - t0)
    if trace_info is not None:
        result["setup"].update(trace_ops=trace_info["n_device_ops"],
                               trace_linked=trace_info["n_linked"])
    result["check"] = v["shown"]
    result["extra"] = dict(served=served, params=params, nums=both, run=run)
    return result
