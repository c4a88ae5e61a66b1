"""Step builders shared by the dry-run (port of ``repro.launch.steps``):
each gives the (function, sharded inputs, placements, output placements)
of an (arch x shape-kind) cell on a mesh.

The reference returns a jit-able function with ``ShapeDtypeStruct`` inputs
and ``NamedSharding`` trees; here the inputs are DTensors whose local
tensors hold no data (meta tensors, or fake tensors when the caller runs
under a ``FakeTensorMode``, as ``repro_torch.launch.dryrun`` does, on
``cuda``), placed by the rules of ``repro_torch.distributed.sharding``.
Calling the function inside ``mesh_context(mesh)`` runs the step eagerly
on the local shards; the output placements are the reference's
``out_shardings``, which the caller redistributes the outputs to.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import axis_size, dp_axes, fsdp_axes
from repro_torch.models import lm
from repro_torch.optim.adam import AdamState, tree_map
from repro_torch.optim.trainer import (TrainConfig, TrainState, create_state,
                                       make_train_step)


def _params_bytes(cfg: ArchConfig) -> float:
    by = {"float32": 4}.get(cfg.param_dtype, 2)
    return cfg.param_counts()["total"] * by


def _abstract(make, device):
    """The tree ``make()`` builds on the CPU, as tensors of its shapes and
    types that hold no data: meta tensors, or fake tensors on ``device``
    under the caller's ``FakeTensorMode`` (no card needed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        tree = make()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), tree)


def abstract_params(cfg: ArchConfig, device="meta"):
    return _abstract(lambda: lm.init_params(cfg, seed=0, device="cpu"),
                     device)


def abstract_caches(cfg: ArchConfig, batch: int, cache_len: int,
                    device="meta"):
    return _abstract(lambda: lm.init_caches(cfg, batch, cache_len,
                                            device="cpu"), device)


def param_templates(cfg: ArchConfig, mesh, *, serve: bool = False,
                    device="meta"):
    """(abstract parameters, placements).

    serve=True takes the weight-stationary Megatron column/row layout when
    a device's share of the weights (all of them over tp) is at most 12e9
    bytes, else the FSDP training layout, as the reference does."""
    params = abstract_params(cfg, device)
    fsdp = fsdp_axes(mesh, params_bytes=_params_bytes(cfg))
    if serve and _params_bytes(cfg) / axis_size(mesh, "model") <= 12e9:
        return params, sh.param_shardings(params, mesh, fsdp=fsdp,
                                          tp="model", serve=True)
    return params, sh.param_shardings(params, mesh, fsdp=fsdp, tp="model")


def default_microbatches(cfg: ArchConfig) -> int:
    """Gradient-accumulation splits: 2 for models of 60 B parameters or
    more (every microbatch gathers the FSDP-sharded weights again), else
    1, as the reference sizes them."""
    return 2 if cfg.param_counts()["total"] >= 6e10 else 1


def _batch_placements(mesh, inputs, dp):
    return {k: sh.placements((dp,) + (None,) * (v.dim() - 1), mesh)
            for k, v in inputs.items()}


def build_train(cfg: ArchConfig, mesh, shape: str = "train_4k",
                tc: Optional[TrainConfig] = None, device="meta"):
    """-> (step_fn, (state, batch), (state placements, batch placements),
    out placements)."""
    tc = tc or TrainConfig(microbatches=default_microbatches(cfg))
    params, p_sh = param_templates(cfg, mesh, device=device)
    state = create_state(sh.distribute(params, mesh, p_sh))
    rep = sh.replicated(mesh)
    state_sh = TrainState(params=p_sh,
                          opt=AdamState(m=p_sh, v=p_sh, t=rep), step=rep)
    dp = dp_axes(mesh)
    inputs = shp.input_specs(cfg, shape, device)
    batch_sh = _batch_placements(mesh, inputs, dp)
    batch = {k: sh.local_shard(v, mesh, batch_sh[k])
             for k, v in inputs.items()}
    out_sh = (state_sh, dict(loss=rep, lr=rep, grad_norm=rep))
    return make_train_step(cfg, tc), (state, batch), (state_sh, batch_sh), \
        out_sh


def build_prefill(cfg: ArchConfig, mesh, shape: str = "prefill_32k",
                  device="meta"):
    """-> (fn(params, tokens, ctx=None), (params, inputs), (param
    placements, input placements), (logit placements, cache
    placements)): the prompt and the serve-ready caches (the prefix padded
    to the capacity, ring tails, plen)."""
    info = shp.SHAPES[shape]
    params, p_sh = param_templates(cfg, mesh, device=device)
    dp = dp_axes(mesh)
    inputs = shp.input_specs(cfg, shape, device)
    in_sh = dict(tokens=sh.placements((dp, None), mesh))
    if "ctx" in inputs:
        in_sh["ctx"] = sh.placements((dp, None, "model"), mesh)

    def fn(params, tokens, ctx=None):
        logits, caches = lm.prefill(params, cfg, tokens, ctx)
        return logits, lm.extend_caches(caches, cfg, info["seq_len"])

    cache_tmpl = abstract_caches(cfg, info["global_batch"], info["seq_len"],
                                 device)
    cache_sh = sh.cache_shardings(cache_tmpl, mesh, dp=dp, tp="model",
                                  shard_seq=True)
    vocab_ax = "model" if cfg.vocab % axis_size(mesh, "model") == 0 else None
    out_sh = (sh.placements((dp, None, vocab_ax), mesh), cache_sh)
    args = {k: sh.local_shard(v, mesh, in_sh[k]) for k, v in inputs.items()}
    return fn, (sh.distribute(params, mesh, p_sh), args), (p_sh, in_sh), \
        out_sh


def build_serve(cfg: ArchConfig, mesh, shape: str, device="meta"):
    """Decode step: one new token against a seq_len cache.  -> (fn(params,
    caches, token, pos), (params, caches, inputs), (param, cache, input
    placements), (logit placements, cache placements)).  ``pos`` is the
    current length as a Python int (the port's ``decode_step`` takes it
    so); the input's stand-in is the reference's int32 scalar."""
    info = shp.SHAPES[shape]
    S, B = info["seq_len"], info["global_batch"]
    params, p_sh = param_templates(cfg, mesh, serve=True, device=device)
    dp = dp_axes(mesh) if B > 1 else None
    caches = abstract_caches(cfg, B, S, device)
    # long-context single request: the sequence over both axes
    cache_sh = sh.cache_shardings(caches, mesh, dp=dp,
                                  tp=("data", "model") if B == 1
                                  else "model", shard_seq=True)
    inputs = shp.input_specs(cfg, shape, device)
    in_sh = dict(token=sh.placements((dp, None), mesh),
                 pos=sh.replicated(mesh))

    def fn(params, caches, token, pos):
        return lm.decode_step(params, cfg, token, caches, pos)

    out_sh = (sh.placements((dp, None, None), mesh), cache_sh)
    args = dict(token=sh.local_shard(inputs["token"], mesh, in_sh["token"]),
                pos=S - 1)
    return fn, (sh.distribute(params, mesh, p_sh),
                sh.distribute(caches, mesh, cache_sh), args), \
        (p_sh, cache_sh, in_sh), out_sh
