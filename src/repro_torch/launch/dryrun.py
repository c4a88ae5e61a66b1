"""The production dry-run (port of ``repro.launch.dryrun``): one cell =
one architecture x one input shape x one production mesh, traced without
a card or an allocation, with its memory, flops and collectives a device.

The reference fakes 512 host devices with ``XLA_FLAGS`` and lowers and
compiles each cell's ``jit`` with its shardings.  Here a fake process
group (``torch.testing._internal.distributed.fake_pg``) of 256 or 512
ranks stands for the devices, and this process is rank 0 of it: the
builders of ``repro_torch.launch.steps`` make the sharded inputs under a
``FakeTensorMode`` (fake ``cuda`` tensors by default, so the traced path
is the kernels' operators, through their fake implementations), and the
step runs eagerly on rank 0's local shards with three dispatch modes on:

  * ``MemTracker`` (``torch.distributed._tools.mem_tracker``): the peak of
    the bytes a device holds at once, the arguments' shards included;
  * a local flop counter: ``FlopCounterMode``'s formulas over the local
    operators (the shapes a device computes on) plus formulas for the
    attention and scan operators (each computed pair or element once);
  * ``repro_torch.launch.hlo_analysis.record_collectives``: each
    collective with its bytes and group size.

Only this entry point makes 256 or 512 fake ranks; it initialises the
fake group when run, never when imported.

The record keeps the reference's keys: ``status`` (OK, SKIP with the
reason of ``cell_supported``, FAIL with the error), ``n_devices``,
``memory`` (argument, output, temp and peak bytes a device, alias 0),
``cost.flops_per_device``, ``collectives`` and ``analytic``
(``model_flops_analytic``, a copy of the reference's).  These have no
counterpart and are left out: ``lower_s`` and ``compile_s`` (no compiler
runs), ``memory.generated_code_bytes`` and ``hlo_chars`` (no generated
code, no HLO text, so no ``--no-hlo``), ``cost.bytes_per_device`` and
``cost.transcendentals`` (XLA's own cost model).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --mesh pod|multipod|both [--out DIR] [--device cuda]
      [--extrapolate] [--reduced]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shapes as shp
from repro_torch.launch.hlo_analysis import (analyze_collectives,
                                             record_collectives)
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     mesh_context)
from repro_torch.launch.steps import build_prefill, build_serve, build_train

DEFAULT_OUT = "experiments/dryrun"
ASSIGNED = [a for a in ARCH_IDS if a not in ("llama3.1-8b", "smolvlm")]


def model_flops_analytic(cfg, shape: str) -> Dict[str, float]:
    """MODEL_FLOPS: 6 N D to train (N the active non-embedding
    parameters, D the tokens), 2 N D to prefill or decode."""
    info = shp.SHAPES[shape]
    pc = cfg.param_counts()
    n_embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_active = max(pc["active"] - n_embed, 1.0)
    if info["kind"] == "train":
        tokens = info["seq_len"] * info["global_batch"]
        return dict(model_flops=6.0 * n_active * tokens, tokens=tokens)
    if info["kind"] == "prefill":
        tokens = info["seq_len"] * info["global_batch"]
        return dict(model_flops=2.0 * n_active * tokens, tokens=tokens)
    tokens = info["global_batch"]
    return dict(model_flops=2.0 * n_active * tokens, tokens=tokens)


# ------------------------------------------------------------ flop counting
def _attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention computes (the kernel skips masked
    tiles; a pair is counted once whatever the tile)."""
    if not causal and not window:
        return Sq * Sk
    total = 0
    for q in range(Sq):
        hi = min(q + 1, Sk) if causal else Sk
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def _attention_flops(q, k, causal, window, backward=False) -> int:
    B, H, Sq, hd = q.shape
    f = 4 * B * H * hd * _attention_pairs(Sq, k.shape[2], causal, window)
    return int(2.5 * f) if backward else f     # QK^T, PV; +dQ, dK, dV, dP


def _custom_flops(func, args) -> Optional[int]:
    name = func.name()
    if name == "repro_torch::flash_attention":
        q, k, _, causal, window, _ = args
        return _attention_flops(q, k, causal, window)
    if name == "repro_torch::flash_attention_backward":
        q, k = args[0], args[1]
        return _attention_flops(q, k, args[6], args[7], backward=True)
    if name in ("repro_torch::ssm_scan", "repro_torch::ssm_scan_backward"):
        dt, a = args[0], args[4]
        per = 6 if name == "repro_torch::ssm_scan" else 15
        return per * dt.numel() * a.shape[1]
    return None


class local_flops(TorchDispatchMode):
    """Flops of the operators a device runs: DTensor operators pass to
    DTensor's dispatch (the mode stays active and sees its local
    operators); DTensor's shape propagation is not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._entry_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        # DTensor's shape propagation runs on meta tensors or under a
        # fake mode of its own (as MemTracker tells them apart)
        if isinstance(first, torch.Tensor) and first.device.type != "meta" \
                and active_fake_mode() is self._entry_mode:
            n = _custom_flops(func, args)
            if n is None and func._overloadpacket in self.registry:
                n = self.registry[func._overloadpacket](*args, **kwargs,
                                                        out_val=out)
            self.flops += n or 0
        return out


# --------------------------------------------------------------- the cells
def _locals(tree):
    """The local tensors of a tree of DTensors and plain tensors."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in _locals(tree)))


def _to_placements(tree, place, mesh):
    """Redistribute the outputs to the builder's output placements (the
    reference's ``out_shardings``)."""
    if isinstance(tree, dict):
        return {k: _to_placements(v, place[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not sh.is_placements(place):
        return type(tree)(*(_to_placements(v, p, mesh)
                            for v, p in zip(tree, place))) \
            if hasattr(tree, "_fields") else type(tree)(
                _to_placements(v, p, mesh) for v, p in zip(tree, place))
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, place)
    return tree


def _patched(cls, name: str, wrap):
    """A context that replaces ``cls.name`` by ``wrap(original)`` (nothing
    when this torch version has no such method)."""
    @contextlib.contextmanager
    def ctx():
        orig = getattr(cls, name, None) if cls is not None else None
        if orig is None:
            yield False
            return
        setattr(cls, name, wrap(orig))
        try:
            yield True
        finally:
            setattr(cls, name, orig)
    return ctx()


def _off_the_trace(fn):
    """``fn`` run outside the trace's fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def run(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def dtensor_bookkeeping_off_the_trace():
    """DTensor's own bookkeeping runs outside the trace's fake mode: the
    shapes it propagates for an operator it has not seen (which would
    reuse the active fake mode, so that the flop counter and MemTracker
    took them for the device's work), and, in torch versions that size a
    ``_StridedShard`` (a [batch x sequence] dimension split over two axes)
    with ``torch.arange(...).tolist()``, that sizing, which a fake mode
    refuses as data dependent.  Yields whether the propagation was moved
    (else :func:`trace_depth` drops a first trace instead)."""
    from torch.distributed.tensor import _sharding_prop, placement_types
    with _patched(_sharding_prop.ShardingPropagator,
                  "_propagate_tensor_meta_non_cached", _off_the_trace) as ok, \
            _patched(getattr(placement_types, "_StridedShard", None),
                     "local_shard_size_and_offset", _off_the_trace):
        yield ok


def trace_cell(cfg, shape: str, mesh, device="cuda") -> Dict:
    """Trace one cell's step on ``mesh`` (rank 0's shards) under a
    FakeTensorMode; returns the record's measured part."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    kind = shp.SHAPES[shape]["kind"]
    with FakeTensorMode(allow_non_fake_inputs=True), mesh_context(mesh), \
            dtensor_bookkeeping_off_the_trace():
        if kind == "train":
            fn, (state, batch), _, out_sh = build_train(cfg, mesh, shape,
                                                        device=device)
            args, call = (state, batch), lambda: fn(state, batch)
        elif kind == "prefill":
            fn, (params, inputs), _, out_sh = build_prefill(cfg, mesh, shape,
                                                            device=device)
            args, call = (params, inputs), lambda: fn(params, **inputs)
        else:
            fn, (params, caches, inputs), _, out_sh = build_serve(
                cfg, mesh, shape, device=device)
            args = (params, caches, inputs["token"])
            call = lambda: fn(params, caches, inputs["token"], inputs["pos"])
        arg_bytes = _nbytes(args)
        mt = MemTracker()
        mt.track_external(*_locals(args))
        with mt, record_collectives() as rec, local_flops() as fl:
            out = _to_placements(call(), out_sh, mesh)
        peak = max((snap.get("Total", 0) for dev, snap in
                    mt.get_tracker_snapshot("peak").items()
                    if torch.device(dev).type == torch.device(device).type),
                   default=0)
        out_bytes = _nbytes(out)
    n_dev = mesh.size()
    colls = analyze_collectives(rec.events, n_devices=n_dev)
    return dict(
        n_devices=n_dev,
        memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                    temp_bytes=max(0.0, float(peak) - arg_bytes - out_bytes),
                    alias_bytes=0.0, peak_bytes=float(peak)),
        cost=dict(flops_per_device=float(fl.flops)),
        collectives=colls.summary())


def _extrapolate(a, b, n: int):
    """Each number of record ``a`` (two periods) and ``b`` (three) carried
    linearly to ``n`` periods: a + (n - 2) (b - a)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _extrapolate(a.get(k, 0), b.get(k, 0), n)
                for k in {**a, **b}}
    out = a + (n - 2) * (b - a)
    return type(a)(round(out)) if isinstance(a, int) else float(out)


def trace_depth(cfg, shape: str, mesh, device="cuda",
                extrapolate: bool = False) -> Dict:
    """:func:`trace_cell` at the config's whole depth, or (``extrapolate``)
    at 2 and 3 of its periods, carried linearly to its depth.  A middle
    period is the same code on the same shapes as the next, so each adds
    the same memory, flops and collectives (the first differs from the
    rest by a few gathers, hence 2 and 3): the counterpart of the
    reference's trip-count correction of a scanned body, where an eager
    trace of Mixtral's 32 layers x 128 MoE token groups would run some
    10^6 DTensor operators.  A first trace of one period runs and is
    dropped before the two depths, and before a whole trace where this
    torch version does not let :func:`dtensor_bookkeeping_off_the_trace`
    move DTensor's shape propagation off the trace, so that what a
    process builds once (the propagation, once an operator, then cached)
    is not counted as the device's work: carried from 2 and 3 periods,
    it would count some 30-fold at Mixtral's depth (the first trace's
    peak reads 4.5 GB high at full width on torch 2.11)."""
    from repro_torch.models.lm import period_of
    from torch.distributed.tensor import _sharding_prop
    p = period_of(cfg)
    at = lambda k: trace_cell(dataclasses.replace(cfg, n_layers=k * p),
                              shape, mesh, device)
    n = cfg.n_layers // p
    extrapolate = extrapolate and n > 3
    if extrapolate or not hasattr(_sharding_prop.ShardingPropagator,
                                  "_propagate_tensor_meta_non_cached"):
        at(1)
    if not extrapolate:
        return trace_cell(cfg, shape, mesh, device)
    a, b = at(2), at(3)
    out = dict(a, memory=_extrapolate(a["memory"], b["memory"], n),
               cost=_extrapolate(a["cost"], b["cost"], n))
    out["collectives"] = dict(
        a["collectives"],
        **_extrapolate({k: a["collectives"][k] for k in (
            "per_kind_bytes", "per_kind_count", "total_wire_bytes")},
            b["collectives"], n))
    out["extrapolated_from_periods"] = [2, 3]
    return out


def init_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    # DTensor caches its sharding plans by mesh shape and axis names, which
    # a new group's meshes share with an earlier group's: cleared, so that
    # no cached plan hands out a mesh whose groups are gone
    for clear in (getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None),
                  getattr(DTensor._op_dispatcher.sharding_propagator
                          .propagate_op_sharding, "cache_clear", None)):
        if clear is not None:
            clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str, *,
             device="cuda", cfg=None,
             mesh_shape=None, extrapolate: bool = False) -> Dict:
    """Dry-run one cell and write its record to ``out_dir``.  ``cfg`` (a
    config given whole) and ``mesh_shape`` ((data, model) of a test mesh
    in place of the production one) are for small cells in tests;
    ``extrapolate``: trace two depths and carry them to the config's
    (:func:`trace_depth`)."""
    cfg = cfg or get_config(arch)
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") \
        if mesh_shape is None else "test{}x{}".format(*mesh_shape)
    rec: Dict = dict(arch=arch, shape=shape, mesh=mesh_name)
    ok, reason = shp.cell_supported(cfg, shape)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{mesh_name}"
    if not ok:
        rec.update(status="SKIP", reason=reason)
        _write(out_dir, tag, rec)
        return rec
    t0 = time.time()
    try:
        if mesh_shape is None:
            init_fake_group(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        else:
            init_fake_group(math.prod(mesh_shape))
            mesh = make_test_mesh(*mesh_shape, device=device)
        rec.update(status="OK", **trace_depth(cfg, shape, mesh, device,
                                              extrapolate),
                   analytic=model_flops_analytic(cfg, shape),
                   trace_s=round(time.time() - t0, 2))
        print(f"[OK]   {tag}: traced in {rec['trace_s']:.1f}s, "
              f"peak/dev {rec['memory']['peak_bytes'] / 2**30:.2f} GiB, "
              f"wire/dev "
              f"{rec['collectives']['total_wire_bytes'] / 2**30:.3f} GiB",
              flush=True)
    except Exception as e:  # a failure here is a bug in the sharding
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    _write(out_dir, tag, rec)
    return rec


def _write(out_dir: str, tag: str, rec: Dict) -> None:
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help=f"one of {ASSIGNED} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(shp.SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (no card is used; a "
                    "torch built without CUDA needs cpu)")
    ap.add_argument("--extrapolate", action="store_true",
                    help="trace 2 and 3 periods and carry them to the "
                    "config's depth (trace_depth)")
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced versions (a quick check of "
                    "the rules and the trace)")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    cells = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        for shape in cells:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out, device=args.device,
                               extrapolate=args.extrapolate,
                               cfg=get_reduced(arch) if args.reduced
                               else None)
                n_fail += rec["status"] == "FAIL"
    print(f"done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
