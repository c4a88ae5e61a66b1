"""Carry the reference's parameters into the port.

Two input forms:

* nested dicts of numpy arrays, as ``jax.tree_util.tree_map(np.asarray,
  tree)`` gives them for the actor, critics and targets, the world model
  and the surrogate (``log_alpha`` is a bare array);
* the flat ``{leaf_name: array}`` layout of the reference checkpoints, with
  names such as ``sac/.params/.actor/l1/w`` or ``sur_params/head/b``
  (``/``-joined dict keys, NamedTuple fields prefixed with ``.``).

The port's parameter trees use the reference's keys, shapes and layouts, so
conversion is a copy to float32 tensors on the requested device.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core import sac as sac_mod
from repro_torch.core import world_model as wm_mod
from repro_torch.optim.adam import AdamState, adam_init


def tree_to_torch(tree, device="cpu"):
    """Nested dicts (or one array) of numpy arrays -> same tree of tensors."""
    if isinstance(tree, Mapping):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr.copy(), device=device)


def unflatten(flat: Mapping[str, np.ndarray], prefix: str = "") -> Dict:
    """Flat ``{a/.b/c: array}`` leaves under ``prefix`` -> nested dict
    ``{a: {b: {c: array}}}`` (the ``.`` of NamedTuple fields dropped)."""
    pre = prefix.rstrip("/") + "/" if prefix else ""
    out: Dict = {}
    for name, arr in flat.items():
        if not name.startswith(pre):
            continue
        parts = [p.lstrip(".") for p in name[len(pre):].split("/")]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    if not out:
        raise KeyError(f"no leaves under {prefix!r}")
    return out


def sac_params(tree: Mapping, device="cpu") -> sac_mod.SACParams:
    """Reference ``SACParams`` fields (actor, q1, q2, q1_targ, q2_targ,
    log_alpha) as a dict of numpy trees -> port ``SACParams``."""
    return sac_mod.SACParams(**{f: tree_to_torch(tree[f], device)
                                for f in sac_mod.SACParams._fields})


def sac_state(params: sac_mod.SACParams) -> sac_mod.SACState:
    """A fresh learner state (zero Adam moments, step 0) around carried
    parameters."""
    dev = params.log_alpha.device
    opt = sac_mod.SACOpt(actor=adam_init(params.actor),
                         q1=adam_init(params.q1), q2=adam_init(params.q2),
                         alpha=adam_init(params.log_alpha))
    return sac_mod.SACState(params=params, opt=opt,
                            step=torch.zeros((), dtype=torch.int32,
                                             device=dev))


def sac_state_from_flat(flat: Mapping[str, np.ndarray], prefix: str = "sac",
                        device="cpu") -> sac_mod.SACState:
    """Rebuild the full learner state (parameters, Adam moments, step) from
    a reference checkpoint's flat leaves under ``prefix``."""
    tree = unflatten(flat, prefix)
    params = sac_params(tree["params"], device)
    o = tree["opt"]
    adam = lambda d: AdamState(m=tree_to_torch(d["m"], device),
                               v=tree_to_torch(d["v"], device),
                               t=tree_to_torch(d["t"], device))
    opt = sac_mod.SACOpt(actor=adam(o["actor"]), q1=adam(o["q1"]),
                         q2=adam(o["q2"]), alpha=adam(o["alpha"]))
    return sac_mod.SACState(params=params, opt=opt,
                            step=tree_to_torch(tree["step"], device))


def world_model_state(params: Mapping, device="cpu") -> wm_mod.WMState:
    """Reference world-model parameters -> a fresh port ``WMState``."""
    p = tree_to_torch(params, device)
    return wm_mod.WMState(params=p, opt=adam_init(p),
                          n_updates=torch.zeros((), dtype=torch.int32,
                                                device=device),
                          ema_loss=torch.tensor(float("inf"), device=device))
