"""The plain reference against the port on the CPU, at float32 copies of
the tiny configurations, and the benchmark's weight tree against the
port's own ``init_params``."""
import pytest
import torch

from conftest import TINY, as_run
from benchlib import model
from reference import lm as ref

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _port():
    from repro_torch.launch import serve
    from repro_torch.models import lm
    return serve, lm


@pytest.mark.parametrize("name", sorted(TINY))
def test_weight_tree_matches_init_params(name):
    _, lm = _port()
    c = as_run(name)
    cfg = model.arch_config(c)
    theirs = lm.init_params(cfg, seed=0, device="cpu")
    ours = model.make_weights(ref.leaf_specs(c), seed=5,
                              device=torch.device("cpu"))

    def flat(tree, pre=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, pre + (k,))
            else:
                yield pre + (k,), (tuple(v.shape), v.dtype)
    assert dict(flat(ours)) == dict(flat(theirs))


def _leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    specs = ref.leaf_specs(as_run("tiny-moe"))
    cpu = torch.device("cpu")
    a = dict(_leaves(model.make_weights(specs, 2**31 + 11, cpu)))
    b = dict(_leaves(model.make_weights(specs, 2**31 + 11, cpu)))
    d = dict(_leaves(model.make_weights(specs, 2**31 + 12, cpu)))
    w = ("blocks", "p0", "e_up")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[w], d[w])


@pytest.mark.parametrize("name,B,S", [("tiny-moe", 2, 48),
                                      ("tiny-moe", 32, 512),
                                      ("tiny-moe", 4, 160)])
def test_reference_equals_port_forward_float32(name, B, S):
    """Every position's logits: the dense MoE path (2 x 48 tokens), the
    grouped capacity dispatch in two groups (32 x 512), and in one group
    (4 x 160)."""
    _, lm = _port()
    c = as_run(name, "float32")
    cfg = model.arch_config(c)
    w = model.make_weights(ref.leaf_specs(c), 7, torch.device("cpu"))
    tok = torch.randint(0, c["vocab"], (B, S),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        theirs = lm.forward(w, cfg, tok)
    ours = ref.logits_at(w, c, tok, range(S), S)
    err = ref.rel_err(theirs, ours)
    assert float(err.max()) < 1e-4


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_follows_generate_float32(name):
    """Prefill then decode through the caches agrees with the reference's
    full forward over the prompt and the served tokens fed back."""
    serve, _ = _port()
    c = as_run(name, "float32")
    cfg = model.arch_config(c)
    w = model.make_weights(ref.leaf_specs(c), 9, torch.device("cpu"))
    B, S, gen = 4, 160, 9
    tok = torch.randint(0, c["vocab"], (B, S),
                        generator=torch.Generator().manual_seed(2))
    g = serve.generate(w, cfg, tok, gen)
    served = torch.as_tensor(g.tokens, dtype=torch.long)
    seq = torch.cat([tok, served[:, :-1]], dim=1)
    want = ref.logits_at(w, c, seq, range(S - 1, S + gen - 1), S)
    assert float(ref.gaps(want, served).max()) < 1e-4
    assert float(ref.rel_err(g.prefill_logits[:, -1], want[:, 0]).max()) \
        < 1e-4


def test_capacity_drops_follow_the_port():
    """One token repeated: every position routes to the same two experts,
    and past the capacity the reference drops what the port drops."""
    _, lm = _port()
    c = as_run("tiny-moe", "float32")
    cfg = model.arch_config(c)
    w = model.make_weights(ref.leaf_specs(c), 3, torch.device("cpu"))
    tok = torch.full((8, 128), 5)
    with torch.no_grad():
        theirs = lm.forward(w, cfg, tok)
    ours = ref.logits_at(w, c, tok, range(128), 128)
    assert float(ref.rel_err(theirs, ours).max()) < 1e-4
    # the drops matter: dropless experts give other logits
    c2 = dict(c, moe_dispatch=dict(c["moe_dispatch"],
                                   dropless_max_tokens=1 << 30))
    dropless = ref.logits_at(w, c2, tok, range(128), 128)
    assert float(ref.rel_err(dropless, ours).max()) > 1e-2


def test_control_rounds_to_float8():
    """The control's products see float8 operands: far from float32, and
    the same as rounding the operands by hand."""
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    wt = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    lo = ref.Ctx("fp8").mm(x, wt)
    hi = ref.Ctx("fp32").mm(x, wt)
    rel = float((lo - hi).norm() / hi.norm())
    assert 1e-3 < rel < 1e-1
    xs = x.abs().amax(-1, keepdim=True) / 448.0
    ws = wt.abs().amax(0, keepdim=True) / 448.0
    by_hand = ((x / xs).to(torch.float8_e4m3fn).float() * xs) @ \
        ((wt / ws).to(torch.float8_e4m3fn).float() * ws)
    assert torch.equal(lo, by_hand)
