"""Carry the reference's parameters into the port.

Two input forms (and a search checkpoint's PER state, below):

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
from repro_torch.core.replay import PERBuffer
from repro_torch.optim.adam import AdamState, adam_init


def tree_to_torch(tree, device="cpu"):
    """Nested dicts (or one array) of numpy arrays -> same tree of tensors."""
    if isinstance(tree, Mapping):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr.copy(), device=device)


def lm_params(tree, device="cpu", mesh=None):
    """The reference's ``lm.init_params`` tree (numpy leaves, as
    ``jax.tree_util.tree_map(np.asarray, ...)`` gives them) -> the port's,
    each leaf keeping its dtype.  A jax bfloat16 array comes out of
    ``np.asarray`` as an ``ml_dtypes`` bfloat16 array (dtype kind ``'V'``),
    which torch does not take: its bits are carried across as uint16.
    ``mesh``: DTensors placed by the training rules (``param_shardings``,
    FSDP over "data", TP over "model")."""
    if mesh is not None:
        from repro_torch.distributed import sharding as sh
        whole = lm_params(tree, device)
        return sh.distribute(whole, mesh, sh.param_shardings(
            whole, mesh, fsdp="data", tp="model"))
    if isinstance(tree, Mapping):
        return {k: lm_params(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


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


def surrogate_params(tree: Mapping, device="cpu") -> Dict:
    """A reference surrogate's parameters (``l1``, ``l2``, ``head``, each
    ``{w, b}``; any hidden widths: the online (128, 64) net or the index's
    (32, 16) one), as nested numpy arrays or under ``sur_params/`` in a
    flat checkpoint layout -> the port's dict of float32 tensors on
    ``device``, each leaf its own contiguous allocation (the
    ``fused_mlp`` kernel takes no views)."""
    if any(isinstance(k, str) and k.startswith("sur_params/") for k in tree):
        tree = unflatten(tree, "sur_params")
    out = {}
    for layer in ("l1", "l2", "head"):
        w, b = np.asarray(tree[layer]["w"]), np.asarray(tree[layer]["b"])
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"surrogate layer {layer}: w {w.shape} and b "
                             f"{b.shape} do not form a dense layer")
        out[layer] = dict(w=tree_to_torch(w, device).contiguous(),
                          b=tree_to_torch(b, device).contiguous())
    if out["l1"]["w"].shape[1] != out["l2"]["w"].shape[0] \
            or out["l2"]["w"].shape[1] != out["head"]["w"].shape[0]:
        raise ValueError("surrogate layers do not chain: "
                         + " -> ".join(str(tuple(out[k]["w"].shape))
                                       for k in ("l1", "l2", "head")))
    return out


def world_model_state(params: Mapping, device="cpu") -> wm_mod.WMState:
    """Reference world-model parameters -> a fresh port ``WMState``."""
    p = tree_to_torch(params, device)
    return wm_mod.WMState(params=p, opt=adam_init(p),
                          n_updates=torch.zeros((), dtype=torch.int32,
                                                device=device),
                          ema_loss=torch.tensor(float("inf"), device=device))


def per_buffer_from_flat(flat: Mapping[str, np.ndarray], extra: Mapping,
                         device="cpu") -> PERBuffer:
    """A search checkpoint's PER state -> a port (device-resident)
    ``PERBuffer``: the ``host/per_*`` arrays and the float64
    ``host/per_tree`` leaves, plus ``buf_pos``, ``buf_size``,
    ``buf_max_priority``, ``buf_beta`` and the ``buf_rng`` stream from the
    manifest's ``extra``.  Both packages write these under the same names,
    so either one's checkpoint carries across."""
    s = flat["host/per_s"]
    buf = PERBuffer(s.shape[1], flat["host/per_a_cont"].shape[1],
                    flat["host/per_a_disc"].shape[1], capacity=s.shape[0],
                    device=device)
    for name in PERBuffer.FIELDS:
        getattr(buf, name).copy_(torch.as_tensor(flat[f"host/per_{name}"]))
    buf.tree.copy_(torch.as_tensor(flat["host/per_tree"]))
    buf.pos, buf.size = int(extra["buf_pos"]), int(extra["buf_size"])
    buf.max_priority = float(extra["buf_max_priority"])
    buf.beta = float(extra["buf_beta"])
    buf.rng.bit_generator.state = extra["buf_rng"]
    return buf
