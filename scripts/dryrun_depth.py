#!/usr/bin/env python3
"""Is a dry-run cell's peak linear in depth, and where in the step is it?

Traces Mixtral 8x7B's train_4k step on the fake 256-rank pod (16 x 16,
fake CUDA tensors, no card used) whole at each depth of ``--periods``, as
``repro_torch.launch.dryrun`` traces a cell, and prints for each depth the
peak bytes a device with MemTracker's split of it by kind, the flops a
device, and the bytes tracked at each MoE group's routing (the forward,
the period's recomputation, each group's recomputation), a timeline of
where the memory stands through the step.  With 2, 3 and 4 periods it
prints the 4-period peak beside the one carried from 2 and 3, as
``dryrun.py --extrapolate`` carries them to the config's depth.

    PYTHONPATH=src python3 scripts/dryrun_depth.py [--periods 1 2 3 4]
    PYTHONPATH=src python3 scripts/dryrun_depth.py --reduced --device cpu

``--reduced`` traces the reduced Mixtral at 8 x 4,096 tokens (four MoE
groups) on a fake 2x2 mesh, small enough for a CPU; the full cell takes
minutes of host time a depth.  The first trace in a process may count
DTensor's shape propagation (see ``dryrun.trace_depth``) and read high
where this torch cannot move the propagation off the trace: a first
depth of 1 takes that cost.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import shapes as shp
from repro_torch.launch.dryrun import (_locals, _nbytes, _to_placements,
                                       dtensor_bookkeeping_off_the_trace,
                                       init_fake_group, local_flops)
from repro_torch.launch.hlo_analysis import record_collectives
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     mesh_context)
from repro_torch.launch.steps import build_train
from repro_torch.models import blocks


def _total(snap, device: str) -> int:
    return max((v.get("Total", 0) for d, v in snap.items()
                if torch.device(d).type == device), default=0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--periods", type=int, nargs="+",
                    default=[1, 2, 3, 4])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu for a torch built "
                    "without CUDA)")
    a = ap.parse_args(argv)
    if a.reduced:
        shp.SHAPES["train_g4"] = dict(seq_len=4096, global_batch=8,
                                      kind="train")
        base, shape = get_reduced("mixtral-8x7b"), "train_g4"
        init_fake_group(4)
        mesh = make_test_mesh(2, 2, device=a.device)
    else:
        base, shape = get_config("mixtral-8x7b"), "train_4k"
        init_fake_group(256)
        mesh = make_production_mesh(multi_pod=False, device=a.device)

    tracker, timeline = [], []
    route = blocks._route

    def watched_route(*args, **kw):
        if tracker:
            timeline.append(_total(tracker[0].get_tracker_snapshot(
                "current"), a.device))
        return route(*args, **kw)
    blocks._route = watched_route

    peaks = {}
    for n in a.periods:
        cfg = dataclasses.replace(base, n_layers=n)
        t0 = time.time()
        timeline.clear()
        with FakeTensorMode(allow_non_fake_inputs=True), \
                mesh_context(mesh), dtensor_bookkeeping_off_the_trace():
            fn, (state, batch), _, out_sh = build_train(cfg, mesh, shape,
                                                        device=a.device)
            arg = _nbytes((state, batch))
            mt = MemTracker()
            mt.track_external(*_locals((state, batch)))
            tracker[:] = [mt]
            with mt, record_collectives(), local_flops() as fl:
                _to_placements(fn(state, batch), out_sh, mesh)
            tracker.clear()
            peak = mt.get_tracker_snapshot("peak")
        peaks[n] = _total(peak, a.device)
        split = {str(k).split(".")[-1]: f"{v:.4e}" for d, s in peak.items()
                 if torch.device(d).type == a.device for k, v in s.items()}
        step = max(1, len(timeline) // 48)
        print(f"periods {n}: peak {peaks[n]:.6e} bytes a device (argument "
              f"{arg:.6e}; by kind {split}), flops {fl.flops:.6e}, traced "
              f"in {time.time() - t0:.1f} s", flush=True)
        print(f"  GB tracked at each group's routing ({len(timeline)} "
              f"calls, every {step}th): "
              + " ".join(f"{v / 1e9:.2f}" for v in timeline[::step]),
              flush=True)
    if {2, 3, 4} <= set(peaks):
        print(f"4 periods traced {peaks[4]:.6e}, carried from 2 and 3 "
              f"{peaks[2] + 2 * (peaks[3] - peaks[2]):.6e}; a period adds "
              f"{peaks[3] - peaks[2]:.6e}, then {peaks[4] - peaks[3]:.6e}",
              flush=True)


if __name__ == "__main__":
    main()
