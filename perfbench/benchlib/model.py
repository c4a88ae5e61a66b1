"""The system under test's configuration and weights, made from a
configuration file's ``as_run`` section and the run's seed.

The weights are drawn on the device in the type they are served in, one
``normal_`` call a leaf (leaves are stacked over periods), into the tree
that the configuration's reference lays out (its ``leaf_specs``) and the
program takes; the same tensors go to the plain reference.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict, List

import torch

from benchlib.cells import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
CHUNK = 1 << 30          # elements a normal_ call fills at most


def _dataclass_of(hint):
    """The dataclass inside a type hint such as ``Optional[MoEConfig]``."""
    for t in (hint,) + typing.get_args(hint):
        if dataclasses.is_dataclass(t):
            return t
    return None


def arch_config(c: Dict):
    """The port's ``ArchConfig`` for ``as_run`` ``c``: every key of ``c``
    that names a field of it, a nested group as the field's own config
    class; raises where the port lays out a period otherwise than the
    file's ``period`` states, or where its MoE capacity is not the file's
    ``moe_dispatch``."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import blocks, lm
    hints = typing.get_type_hints(ArchConfig)
    kw = {}
    for f in dataclasses.fields(ArchConfig):
        if f.name not in c:
            continue
        v, cls = c[f.name], _dataclass_of(hints[f.name])
        kw[f.name] = cls(**v) if cls is not None and v is not None else v
    cfg = ArchConfig(**kw)
    p, _, slots = lm._layout(cfg)
    want = [(s["kind"], s["moe"]) for s in c["period"]]
    if p != len(want) or list(slots) != want:
        raise ValueError(f"{c['name']}: the port lays out a period as "
                         f"{slots}, the configuration states {want}")
    if c.get("moe") and blocks.MOE_CAPACITY != \
            c["moe_dispatch"]["capacity_factor"]:
        raise ValueError(f"the port's MoE capacity {blocks.MOE_CAPACITY} is "
                         "not the configuration's")
    return cfg


def make_weights(specs: List[tuple], seed: int, device) -> Dict:
    """The weights that ``specs`` (a reference's ``leaf_specs``) lay out,
    from ``seed``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    tree: Dict = {}
    for path, shape, dtn, init in specs:
        t = torch.empty(shape, dtype=DTYPES[dtn], device=device)
        if init[0] == "normal":
            flat = t.view(-1)
            for lo in range(0, flat.numel(), CHUNK):
                flat[lo:lo + CHUNK].normal_(0.0, init[1], generator=gen)
        elif init[0] == "zeros":
            t.zero_()
        elif init[0] == "ones":
            t.fill_(1.0)
        else:
            raise ValueError(f"init {init!r}")
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree
