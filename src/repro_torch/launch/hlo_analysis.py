"""Collective-byte accounting (port of ``repro.launch.hlo_analysis``; the
name is kept so that a reader finds the counterpart).

The reference parses the compiled HLO text: it finds every collective,
multiplies those inside ``while`` loops (``lax.scan`` bodies) by the
loop's trip count, and sums each kind's wire bytes a device with the ring
factors below.  The port has no HLO text: :func:`record_collectives` is a
dispatch mode that records each ``torch.distributed`` collective as it is
dispatched, functional (``_c10d_functional``, what DTensor's
redistributions issue) or in place (``c10d``, ``dist.all_reduce``), with
its bytes and its group's size.  Eager torch dispatches a loop's
collectives once an iteration, so the counts come out right by
construction and the trip-count correction has no work to do:
``n_while_loops`` and ``trip_counts`` stay empty.

Ring-cost factors (bytes on the wire a device, n the group's size):
  all-gather       (n-1)/n * out_bytes
  reduce-scatter   (n-1)/n * in_bytes
  all-reduce       2(n-1)/n * bytes
  all-to-all       (n-1)/n * bytes
  collective-permute        bytes
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode


class Collective(NamedTuple):
    kind: str       # the reference's HLO names: all-reduce, all-gather, ...
    nbytes: int     # bytes of the operand the ring factor applies to
    group_size: int


@dataclasses.dataclass
class CollectiveStats:
    per_kind_bytes: Dict[str, float]
    per_kind_count: Dict[str, int]
    total_wire_bytes: float
    n_while_loops: int
    trip_counts: Dict[str, int]

    def summary(self) -> Dict:
        return dict(per_kind_bytes=self.per_kind_bytes,
                    per_kind_count=self.per_kind_count,
                    total_wire_bytes=self.total_wire_bytes,
                    n_while_loops=self.n_while_loops,
                    trip_counts=self.trip_counts)


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=None)
def _named_group_size(name: str) -> int:
    from torch.distributed import distributed_c10d as c10d
    return c10d._resolve_process_group(name).size()


def _group_size(name_or_pg) -> int:
    from torch.distributed import distributed_c10d as c10d
    if isinstance(name_or_pg, str):
        return _named_group_size(name_or_pg)
    return c10d.ProcessGroup.unbox(name_or_pg).size()


# the collectives DTensor's redistributions issue: op name -> (kind,
# which operand's bytes: "in" or "out"); and ``dist.all_reduce``'s
_FUNCTIONAL = {"all_reduce": ("all-reduce", "in"),
               "all_gather_into_tensor": ("all-gather", "out"),
               "reduce_scatter_tensor": ("reduce-scatter", "in"),
               "all_to_all_single": ("all-to-all", "in")}
_INPLACE = {"allreduce_": "all-reduce"}


class record_collectives(TorchDispatchMode):
    """``with record_collectives() as rec:`` ... ``rec.events`` lists a
    :class:`Collective` for every collective dispatched inside.  An
    operator on DTensors passes to DTensor's dispatch with the mode still
    active, so that the collectives of its redistributions and the local
    operators are seen."""

    def __init__(self):
        super().__init__()
        self.events: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, which = _FUNCTIONAL[name]
            group = kwargs.get("group_name", args[-1])
            self.events.append(Collective(
                kind, _nbytes(args[0] if which == "in" else out),
                _group_size(group)))
        elif ns == "c10d" and name in _INPLACE:
            kind = _INPLACE[name]
            pg = next(a for a in args
                      if isinstance(a, torch.ScriptObject))
            self.events.append(Collective(kind, _nbytes(args[0]),
                                          _group_size(pg)))
        return out


def analyze_collectives(events: List[Collective], n_devices: int = 1
                        ) -> CollectiveStats:
    """Wire bytes a device and counts by kind over recorded collectives
    (``n_devices`` is the group size for an event that has none)."""
    kinds_bytes: Dict[str, float] = {}
    kinds_count: Dict[str, int] = {}
    total = 0.0
    for ev in events:
        n = ev.group_size or n_devices
        frac = (n - 1) / max(n, 1)
        if ev.kind == "all-reduce":
            wire = 2.0 * frac * ev.nbytes
        elif ev.kind == "collective-permute":
            wire = float(ev.nbytes)
        else:
            wire = frac * ev.nbytes
        kinds_bytes[ev.kind] = kinds_bytes.get(ev.kind, 0.0) + wire
        kinds_count[ev.kind] = kinds_count.get(ev.kind, 0) + 1
        total += wire
    return CollectiveStats(per_kind_bytes=kinds_bytes,
                           per_kind_count=kinds_count,
                           total_wire_bytes=total, n_while_loops=0,
                           trip_counts={})
