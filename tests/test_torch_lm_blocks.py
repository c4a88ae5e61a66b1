"""The port's LM layers, attention functions and blocks against the JAX
reference (``repro.models.{layers,attention,blocks}``) on the same seeded
inputs and converted reference weights: float32 at 1e-5 relative to the
largest output (another order of sums), bf16 at the rounding of a bf16
output.  ``_moe`` is held on each of its three paths: one token per row
(decode), T <= 512 tokens (dense-masked) and T = 768 (capacity dispatch);
the capacity dispatch's row indices also against the one-hot einsums that
DTensors keep, outputs and gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blk
from repro.models import layers as ref_L
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.configs.base import MoEConfig as TorchMoE
from repro.configs.base import MoEConfig as RefMoE
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import layers as L

RNG = np.random.default_rng(11)


def _close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * scale, (err, scale)


def _cfgs(arch, **kw):
    """The reduced config in both packages, float32 unless kw says."""
    kw = dict(dict(param_dtype="float32"), **kw)
    return (dataclasses.replace(ref_reduced(arch), **kw),
            dataclasses.replace(get_reduced(arch), **kw))


def _x(shape, scale=1.0):
    return (RNG.normal(0, 1, shape) * scale).astype(np.float32)


def _block(rcfg, kind, moe_on, seed=0):
    p = ref_blk.block_init(jax.random.PRNGKey(seed), rcfg, kind, moe_on)
    return p, convert.lm_params(jax.tree_util.tree_map(np.asarray, p))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_layers_match_reference(dtype, rel):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = L.dtype_of(dtype)
    x = _x((2, 5, 3, 16))
    pos = RNG.integers(0, 1000, (2, 5))
    _close(L.apply_rope(torch.as_tensor(x).to(td), torch.as_tensor(pos),
                        5e5),
           ref_L.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 5e5), rel)
    scale = _x((16,))
    _close(L.rmsnorm(dict(scale=torch.as_tensor(scale).to(td)),
                     torch.as_tensor(x).to(td), 1e-5),
           ref_L.rmsnorm(dict(scale=jnp.asarray(scale, jd)),
                         jnp.asarray(x, jd), 1e-5), rel)
    g, u = _x((4, 16)), _x((4, 16))
    _close(L.swiglu(torch.as_tensor(g).to(td), torch.as_tensor(u).to(td)),
           ref_L.swiglu(jnp.asarray(g, jd), jnp.asarray(u, jd)), rel)
    w, b = _x((16, 8)), _x((8,))
    _close(L.linear(dict(w=torch.as_tensor(w).to(td),
                         b=torch.as_tensor(b).to(td)),
                    torch.as_tensor(g).to(td)),
           ref_L.linear(dict(w=jnp.asarray(w, jd), b=jnp.asarray(b, jd)),
                        jnp.asarray(g, jd)), rel)
    # float32 input through a half-precision weight promotes to float32
    # (the Mamba dt projection)
    got = L.linear(dict(w=torch.as_tensor(w).to(td)), torch.as_tensor(g))
    assert got.dtype == torch.float32
    _close(got, ref_L.linear(dict(w=jnp.asarray(w, jd)), jnp.asarray(g)),
           1e-6)
    tok = RNG.integers(0, 8, (2, 3))
    assert torch.equal(L.embed(dict(w=torch.as_tensor(w)),
                               torch.as_tensor(tok)),
                       torch.as_tensor(w)[torch.as_tensor(tok)])
    a, c = _x((3, 4, 16)), _x((3, 16, 5))
    _close(L.einsum_f32("bij,bjk->bik", torch.as_tensor(a).to(td),
                        torch.as_tensor(c).to(td)),
           ref_L.einsum_f32("bij,bjk->bik", jnp.asarray(a, jd),
                            jnp.asarray(c, jd)), 1e-6)


# --------------------------------------------------------------- attention
def test_decode_attention_functions_match_reference():
    B, S, H, Hk, hd = 2, 10, 4, 2, 16
    q, k, v = _x((B, 1, H, hd)), _x((B, S, Hk, hd)), _x((B, S, Hk, hd))
    T = lambda a: torch.as_tensor(a)
    for length, window in ((7, 0), (10, 4)):
        _close(attn.decode_attention(T(q), T(k), T(v), T(length),
                                     window=window),
               ref_attn.decode_attention(q, k, v, length, window=window),
               1e-6)
    parts, ref_parts = [], []
    for length in (np.array(6), np.array([3, 9])):
        got = attn.decode_attention_stats(T(q), T(k), T(v), T(length))
        want = ref_attn.decode_attention_stats(q, k, v, length)
        for g, w in zip(got, want):
            _close(g, w, 1e-6)
        parts.append(got)
        ref_parts.append(want)
    _close(attn.merge_attention(parts, torch.float32),
           ref_attn.merge_attention(ref_parts, jnp.float32), 1e-6)
    new_k, new_v = _x((B, 1, Hk, hd)), _x((B, 1, Hk, hd))
    for g, w in zip(attn.cache_update(T(k), T(v), T(new_k), T(new_v),
                                      torch.tensor(4, dtype=torch.int32)),
                    ref_attn.cache_update(k, v, new_k, new_v, 4)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # chunked_attention ([B,S,H,hd] in and out) through the kernel's plain
    # version, against the reference's own jnp chunked attention
    q2 = _x((B, S, H, hd))
    _close(attn.chunked_attention(T(q2), T(k), T(v), window=3),
           ref_attn.chunked_attention(q2, k, v, window=3, q_chunk=S), 1e-6)


# ------------------------------------------------------------------ blocks
CASES = [  # arch, kind, moe_on, config changes
    ("llama3.1-8b", "attn", False, {}),
    ("llama3.1-8b", "attn", False, dict(qkv_bias=True, sliding_window=5)),
    ("llama3.1-8b", "attn", False, dict(mlp_gated=False)),
    ("jamba-v0.1-52b", "attn", False, {}),
    ("jamba-v0.1-52b", "mamba", True, {}),
    ("jamba-v0.1-52b", "mamba", False, {}),
]


@pytest.mark.parametrize("arch,kind,moe_on,kw", CASES)
def test_block_apply_and_decode_match_reference(arch, kind, moe_on, kw):
    rcfg, tcfg = _cfgs(arch, **kw)
    rp, tp = _block(rcfg, kind, moe_on)
    B, S, d = 2, 9, rcfg.d_model
    x = _x((B, S, d))
    got, tc = blk.block_apply(tp, tcfg, kind, moe_on, torch.as_tensor(x),
                              collect_cache=True)
    want, rc = ref_blk.block_apply(rp, rcfg, kind, moe_on, jnp.asarray(x),
                                   collect_cache=True)
    _close(got, want, 1e-5)
    rc = {k: v for k, v in rc.items() if k in tc}   # MLA-only keys aside
    assert set(tc) == set(rc)
    for name in tc:
        _close(tc[name], rc[name], 1e-5)
    # one decode step against a cache of random contents
    cache_len = 16
    rcache = ref_blk.init_cache(rcfg, kind, B, cache_len, jnp.float32)
    rcache = {k: (jnp.asarray(_x(v.shape)) if v.dtype == jnp.float32
                  else jnp.asarray(5, jnp.int32)) for k, v in rcache.items()}
    tcache = {k: torch.as_tensor(np.array(v)) for k, v in rcache.items()}
    x_t = _x((B, 1, d))
    got, tnew = blk.block_decode(tp, tcfg, kind, moe_on, torch.as_tensor(x_t),
                                 tcache, 7)
    want, rnew = ref_blk.block_decode(rp, rcfg, kind, moe_on,
                                      jnp.asarray(x_t), rcache,
                                      jnp.asarray(7))
    _close(got, want, 1e-5)
    for name in tnew:
        _close(tnew[name], rnew[name], 1e-5)


@pytest.mark.parametrize("B,S", [(1, 1), (5, 1), (4, 96), (2, 384)])
@pytest.mark.parametrize("variant", ["swiglu", "gelu", "shared"])
def test_moe_paths_match_reference(B, S, variant):
    """T = B*S tokens: 1 and 5 take the decode gather, 384 the dense-masked
    path, 768 the capacity dispatch.  The router is sharpened and the
    inputs share an offset, so that one expert draws more tokens than its
    capacity and the dispatch drops some."""
    kw = dict(moe=TorchMoE(n_experts=4, top_k=2, every=2,
                           shared_expert=variant == "shared"),
              mlp_gated=variant != "gelu")
    rkw = dict(kw, moe=RefMoE(n_experts=4, top_k=2, every=2,
                              shared_expert=variant == "shared"))
    rcfg = dataclasses.replace(ref_reduced("jamba-v0.1-52b"),
                               param_dtype="float32", **rkw)
    tcfg = dataclasses.replace(get_reduced("jamba-v0.1-52b"),
                               param_dtype="float32", **kw)
    rp, tp = _block(rcfg, "mamba", True, seed=B)
    rp = dict(rp, router=dict(w=rp["router"]["w"] * 30.0))
    tp = dict(tp, router=dict(w=tp["router"]["w"] * 30.0))
    h = _x((B, S, rcfg.d_model)) + 2.0
    got = blk._moe(tp, tcfg, torch.as_tensor(h))
    want = ref_blk._moe(rp, rcfg, jnp.asarray(h))
    _close(got, want, 1e-5)
    if B * S > 512:
        _, idx = blk._route(tp, torch.as_tensor(h).reshape(B * S, -1), 2)
        load = torch.bincount(idx.flatten(), minlength=4)
        assert int(load.max()) > int(blk.MOE_CAPACITY * 2 * B * S / 4)


@pytest.mark.parametrize("kind", ["attn", "mamba"])
def test_init_cache_matches_reference_layout(kind):
    rcfg, tcfg = _cfgs("jamba-v0.1-52b", param_dtype="bfloat16")
    want = ref_blk.init_cache(rcfg, kind, 3, 20, jnp.bfloat16)
    got = blk.init_cache(tcfg, kind, 3, 20, torch.bfloat16, "cpu")
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


_INDEX = (blk._index_dispatch, blk._index_combine)
_ONEHOT = (blk._onehot_dispatch, blk._onehot_combine)


def _recording(dispatch, combine, seen):
    """``dispatch`` and ``combine`` with each call's expert inputs (in
    ``seen["xe"]``), and each combine's expert outputs, combined rows and
    the bound on their rounding (in ``seen["out"]``): the gated sum of the
    |rows| each token reads, by index."""
    def disp(ht, onehot, ix, pos_k, keep_k, cap):
        xe, plan = dispatch(ht, onehot, ix, pos_k, keep_k, cap)
        seen["xe"].append(xe.detach().clone())
        seen["slot"] = _INDEX[0](ht, onehot, ix, pos_k, keep_k, cap)[1]
        return xe, plan

    def comb(ye, plan, onehot, gv):
        out = combine(ye, plan, onehot, gv)
        seen["out"].append(dict(
            ye=ye.detach().clone(), out=out.detach().clone(),
            kept=(seen["slot"] < ye.shape[0] * ye.shape[1]).sum(1),
            full=bool((seen["slot"] == ye.shape[0] * ye.shape[1] - 1).any()),
            mag=_INDEX[1](ye.detach().abs(), seen["slot"], onehot,
                          gv.detach().abs())))
        return out
    return disp, comb


@pytest.mark.parametrize("B,S", [(2, 384), (2, 4160)])
@pytest.mark.parametrize("variant", ["swiglu", "gelu", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_index_path_matches_onehot(B, S, variant, dtype, monkeypatch):
    """The grouped path's row-index dispatch and combine against the
    one-hot einsums that DTensors keep, on plain tensors: 768 tokens (one
    group) and 8,320 (two groups of 4,160, each through ``L.remat``), the
    router sharpened so that tokens drop.  Exact: the experts' inputs and
    outputs, each token's combined row where at most one of its choices
    was kept, and the experts' (and shared expert's) gradients, since
    each expert slot takes one (token, choice) and each of its backward
    products one term.  A token with two kept choices sums two products,
    which the one-hot GEMM rounds fused or not by where the two slots fall
    in its K tiling: within 2^-22 of the sum of their magnitudes, twice
    one fp32 rounding of each; downstream, the dtype's rounding."""
    td = L.dtype_of(dtype)
    cfg = dataclasses.replace(
        get_reduced("jamba-v0.1-52b"), param_dtype=dtype,
        mlp_gated=variant != "gelu",
        moe=TorchMoE(n_experts=4, top_k=2, every=2,
                     shared_expert=variant == "shared"))
    gen = torch.Generator().manual_seed(S)
    p = blk.block_init(gen, cfg, "mamba", True)
    p = {k: v for k, v in p.items() if k in (
        "router", "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")}
    h = (torch.randn(B, S, cfg.d_model, generator=gen) + 2.0).to(td)
    # the most loaded expert last, so that the last slot is taken and a
    # dropped choice reads a real row under its zero gate
    w = p["router"]["w"] * 30.0
    load = torch.bincount(blk._route(dict(router=dict(w=w)),
                                     h.reshape(B * S, -1),
                                     2)[1].flatten(), minlength=4)
    p["router"] = dict(w=w[:, torch.argsort(load)])
    leaves = {k: (v["w"] if isinstance(v, dict) else v).requires_grad_()
              for k, v in p.items()}
    h.requires_grad_()
    cot = torch.randn(B, S, cfg.d_model, generator=gen)

    def run(dispatch, combine):
        seen = dict(xe=[], out=[])
        disp, comb = _recording(dispatch, combine, seen)
        monkeypatch.setattr(blk, "_index_dispatch", disp)
        monkeypatch.setattr(blk, "_index_combine", comb)
        out = blk._moe(p, cfg, h)
        grads = torch.autograd.grad((out.float() * cot).sum(),
                                    [h, *leaves.values()])
        return out.detach(), dict(zip(["h", *leaves], grads)), seen

    out_i, grad_i, seen_i = run(*_INDEX)
    out_o, grad_o, seen_o = run(*_ONEHOT)
    # a forward a group (with two groups, remat's recomputed dispatches too)
    n_groups = 1 if S == 384 else 2
    assert len(seen_i["out"]) == len(seen_o["out"]) == n_groups
    assert len(seen_i["xe"]) == len(seen_o["xe"]) >= n_groups
    for a, b in zip(seen_i["xe"], seen_o["xe"]):
        assert torch.equal(a, b)
    for a, b in zip(seen_i["out"], seen_o["out"]):
        assert torch.equal(a["ye"], b["ye"])
        kept = a["kept"]
        assert (kept < 2).any() and (kept == 2).any()     # drops, and sums
        assert a["full"]
        one = kept <= 1
        assert torch.equal(a["out"][one], b["out"][one])
        assert bool(((a["out"] - b["out"]).abs()
                     <= 2.0 ** -22 * a["mag"]).all())
    _close(out_i, out_o.float().numpy(), 1e-6 if dtype == "float32" else
           1e-2)
    for k in leaves:
        if k != "router":
            assert torch.equal(grad_i[k], grad_o[k]), k
    rel = 1e-5 if dtype == "float32" else 1e-2
    _close(grad_i["h"], grad_o["h"].float().numpy(), rel)
    _close(grad_i["router"], grad_o["router"].float().numpy(), rel)
