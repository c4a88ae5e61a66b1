#!/usr/bin/env python3
"""The serving spans of ``repro_torch.launch.serve.generate`` in a cell of
the benchmark, each run a fresh process: one window of the cell
(``perfbench/benchlib/runner.run_cell``), then the process registry's
per-span host and device seconds, calls and MoE counters, and the window's
end-to-end rates, as one JSON line appended to ``DIR/runs.jsonl``.

Modes:
  profiler  the benchmark's traced run (the profiler records, so the
            program's spans are on);
  veto      the same with ``REPRO_TRACE=0`` (only the benchmark's ranges);
  tracer    an untraced run with a ``repro_torch.obs`` Tracer installed on
            ``DIR/<cell>.<seed>.trace.jsonl`` (spans on, no profiler);
  off       an untraced run with the spans off.

    python3 scripts/serve_spans.py --out DIR \
        --run mixtral.chat-sharegpt:2147485611:40:profiler [--run ...]
    python3 scripts/serve_spans.py --out DIR --check
    python3 scripts/serve_spans.py --out DIR \
        --host-calls mixtral.chat-sharegpt:2147485611:20

``--host-calls cell:seed:steps`` serves the cell's longest prompt shape
for ``steps`` decode steps under the profiler and prints the host
operations and CUDA runtime calls by host time: which call the host waits
in.  ``--check`` serves a reduced Mixtral (2 x 320 prompt tokens, 8
tokens) on the card with the spans off and under a tracer
(``DIR/check.trace.jsonl``), and fails unless both give the same tokens
and the registry holds every span.  ``--root`` names another checkout's
root (a miniature one for a rehearsal on the CPU, with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _paths(root: Path) -> None:
    """The environment of ``perfbench/run.py``."""
    cache = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]


def _registry_tables():
    from repro_torch.obs import metrics
    spans, counters = {}, {}
    for row in metrics.global_registry().snapshot()["counters"]:
        name, lb = row["name"], row["labels"]
        if name.startswith("lm_span_"):
            kind = name[len("lm_span_"):-len("_total")]
            spans.setdefault(lb["span"], {})[kind] = row["value"]
        else:
            key = name + "".join(f"{{{k}={v}}}" for k, v in lb.items())
            counters[key] = row["value"]
    return spans, counters


def one(root: Path, cell: str, seed: int, seconds: float, mode: str,
        out: Path, device: str) -> dict:
    _paths(root)
    import torch
    from benchlib import cells, runner
    from repro_torch.obs import trace as obs_trace
    dev = torch.device(device)
    tracer = None
    if mode == "tracer":
        tracer = obs_trace.Tracer(str(out / f"{cell}.{seed}.trace.jsonl"),
                                  proc="serve")
        obs_trace.install_tracer(tracer)
    try:
        res = runner.run_cell(cell, seed, seconds, mode in ("profiler",
                                                           "veto"),
                              dev=dev, t_process=time.perf_counter(),
                              root=root)
    finally:
        if tracer is not None:
            obs_trace.install_tracer(None)
            tracer.close()
    run = res.pop("extra")["run"]
    bench = cells.benchmark(root)
    rates = {}
    for m in cells.metrics_for(bench, cell, False):
        v = cells.reader(m["name"])(run)
        if isinstance(v, dict):
            v = v["value"]
        rates[m["name"]] = v
    spans, counters = _registry_tables()
    ranges = (run.trace or {}).get("span_device_s", {})
    return dict(cell=cell, seed=seed, mode=mode, result=res,
                window_rates=rates, spans=spans, counters=counters,
                range_device_s=ranges,
                requests=len(run.requests),
                decode_steps=sum(r.shape.gen_tokens - 1
                                 for r in run.requests))


def check(out: Path, device: str) -> int:
    _paths(ROOT)
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.obs import metrics
    from repro_torch.obs import trace as obs_trace
    cfg = get_reduced("mixtral-8x7b")
    params, prompts, _ = serve.inputs(cfg, 2, 320, 0, device)
    plain = serve.generate(params, cfg, prompts, 8)
    assert metrics.global_registry().snapshot()["counters"] == []
    path = out / "check.trace.jsonl"
    tracer = obs_trace.Tracer(str(path), proc="check")
    obs_trace.install_tracer(tracer)
    try:
        traced = serve.generate(params, cfg, prompts, 8)
    finally:
        obs_trace.install_tracer(None)
        tracer.close()
    np.testing.assert_array_equal(plain.tokens, traced.tokens)
    assert torch.equal(plain.prefill_logits, traced.prefill_logits)
    spans, counters = _registry_tables()
    print(json.dumps(dict(spans=spans, counters=counters)))
    want = {"serve.request", "serve.prefill", "serve.decode_step", "moe",
            "moe.gather", "moe.dispatch", "moe.combine", "attn", "lm.head"}
    assert want <= set(spans), sorted(spans)
    assert all(s["device_seconds"] >= 0 for s in spans.values())
    assert spans["moe"]["device_seconds"] > 0
    return 0


def host_calls(cell: str, seed: int, steps: int, device: str) -> int:
    _paths(ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from benchlib import cells, model, traffic
    from repro_torch.launch import serve
    bench = cells.benchmark(ROOT)
    w = cells.cell(bench, cell)
    conf = cells.config(bench, w["config"], ROOT)
    c = conf["as_run"]
    tr = cells.traffic(w["traffic"], ROOT)
    cfg = model.arch_config(c)
    dev = torch.device(device)
    params = model.make_weights(cells.module(conf["reference"]).leaf_specs(c),
                                seed, dev)
    shape = max(traffic.shapes(tr), key=lambda s: s.prompt_len)
    prompts = traffic.prompts(shape, cfg.vocab, seed, 0, dev)
    serve.generate(params, cfg, prompts, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g = serve.generate(params, cfg, prompts, steps + 1)
    print(f"{steps} steps, {1e3 * g.t_decode / steps:.2f} ms a step")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=30, max_name_column_width=60))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--run", action="append", default=[],
                    metavar="CELL:SEED:SECONDS:MODE")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--host-calls", default=None, metavar="CELL:SEED:STEPS")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if a.check:
        return check(out, a.device)
    if a.host_calls:
        cell, seed, steps = a.host_calls.split(":")
        return host_calls(cell, int(seed), int(steps), a.device)
    if a.one:
        cell, seed, secs, mode = a.one.split(":")
        row = one(Path(a.root), cell, int(seed), float(secs), mode, out,
                  a.device)
        print(json.dumps(row), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if a.device == "cuda" \
        else "cpu"
    print(f"card: {smi}", flush=True)
    with open(out / "runs.jsonl", "a") as log:
        for r in a.run:
            mode = r.rsplit(":", 1)[1]
            env = dict(os.environ)
            env.pop("REPRO_TRACE", None)
            if mode == "veto":
                env["REPRO_TRACE"] = "0"
            t = time.time()
            p = subprocess.run(
                [sys.executable, __file__, "--one", r, "--out", str(out),
                 "--root", a.root, "--device", a.device],
                env=env, capture_output=True, text=True)
            try:
                row = json.loads(p.stdout.strip().splitlines()[-1])
            except (IndexError, ValueError):
                row = dict(run=r, rc=p.returncode,
                           stderr=p.stderr[-3000:])
            row.update(wall_s=time.time() - t, card=smi)
            log.write(json.dumps(row) + "\n")
            log.flush()
            brief = {k: row.get(k) for k in ("window_rates", "requests",
                                             "decode_steps")}
            res = row.get("result") or {}
            got = {k: round(v["value"], 4)
                   for k, v in res.get("metrics", {}).items()}
            print(f"{r}: rc {p.returncode} wall {row['wall_s']:.1f} s "
                  f"correct {res.get('correct')} {brief} metrics {got}",
                  flush=True)
            if p.returncode:
                print(p.stderr[-2500:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
