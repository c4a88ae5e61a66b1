"""The port's learner against the JAX reference with the reference's own
weights and random draws: weights carried across, acting, one SAC update
(losses, TD errors, gradients, new parameters), the surrogate and
world-model steps, and MPC planning (CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.core import mpc as ref_mpc
from repro.core import networks as ref_nets
from repro.core import sac as ref_sac
from repro.core import world_model as ref_wm
from repro.core.actions import N_CONT, N_DISC
from repro.core.state import SAC_STATE_DIM
from repro.optim.adam import adam_update as ref_adam_update
from repro.ppa import analytic as ref_an
from repro.ppa import surrogate as ref_sur
from repro_torch import convert
from repro_torch.core import mpc
from repro_torch.core import networks as nets
from repro_torch.core import sac
from repro_torch.core import world_model as wm
from repro_torch.ppa import surrogate as sur

# fp32 autograd vs XLA autodiff: same math, sums in another order
RTOL, ATOL = 1e-4, 1e-6
B = 32
T = torch.as_tensor
J = jnp.asarray
np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                               else tree)}


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL, mask=None):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    m = _leaves(mask) if mask is not None else None
    for k in g:
        assert g[k].shape == w[k].shape, k
        sel = m[k] if m is not None else np.ones(g[k].shape, bool)
        np.testing.assert_allclose(g[k][sel], w[k][sel], rtol=rtol,
                                   atol=atol, err_msg=k)


def _ref_sac(seed=0):
    st = ref_sac.create(seed)
    tree = {f: np_tree(getattr(st.params, f))
            for f in ref_sac.SACParams._fields}
    return st, convert.sac_state(convert.sac_params(tree))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        s=rng.normal(0, 1, (B, SAC_STATE_DIM)).astype(np.float32),
        a_cont=rng.uniform(-1, 1, (B, N_CONT)).astype(np.float32),
        a_disc=rng.integers(0, 5, (B, N_DISC)).astype(np.int32),
        r=rng.normal(0, 1, B).astype(np.float32),
        s2=rng.normal(0, 1, (B, SAC_STATE_DIM)).astype(np.float32),
        done=np.zeros(B, np.float32),
        is_w=rng.uniform(0.2, 1.0, B).astype(np.float32))


def test_weights_carried_across_both_forms(tmp_path):
    st, port = _ref_sac(0)
    for f in ref_sac.SACParams._fields:
        _assert_tree_close(getattr(port.params, f), getattr(st.params, f),
                           rtol=0, atol=0)
    # the flat checkpoint layout: full learner state, Adam moments and step
    # included (made nonzero so that a mix-up would show)
    st2 = st._replace(
        opt=jax.tree_util.tree_map(lambda x: x + 1, st.opt),
        step=st.step + 3)
    wm_st = ref_wm.create(1)
    sur_p = ref_sur.Surrogate.create(SAC_STATE_DIM + N_CONT, seed=2).params
    ref_ckpt.save(dict(sac=st2, wm=wm_st.params, sur_params=sur_p),
                  str(tmp_path), 7)
    flat, _ = ref_ckpt.restore_flat(str(tmp_path))
    got = convert.sac_state_from_flat(flat, "sac")
    for f in ref_sac.SACParams._fields:
        _assert_tree_close(getattr(got.params, f), getattr(st2.params, f),
                           rtol=0, atol=0)
    for f in ("actor", "q1", "q2", "alpha"):
        for part in ("m", "v", "t"):
            _assert_tree_close(getattr(getattr(got.opt, f), part),
                               getattr(getattr(st2.opt, f), part),
                               rtol=0, atol=0)
    assert int(got.step) == int(st2.step)
    _assert_tree_close(convert.tree_to_torch(convert.unflatten(flat, "wm")),
                       wm_st.params, rtol=0, atol=0)
    _assert_tree_close(convert.tree_to_torch(
        convert.unflatten(flat, "sur_params")), sur_p, rtol=0, atol=0)


def test_policy_act_batch_with_reference_noise():
    st, port = _ref_sac(3)
    s = np.random.default_rng(2).normal(0, 1, (64, SAC_STATE_DIM)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    kc, kd = jax.random.split(key)
    noise = nets.PolicyNoise(T(np.asarray(jax.random.normal(kc, (64, N_CONT)))),
                             T(np.asarray(jax.random.gumbel(kd, (64, 4, 5)))))
    a_ref, d_ref = ref_sac.policy_act_batch(st.params.actor, J(s), key)
    a, d = sac.policy_act_batch(port.params.actor, T(s), noise=noise)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


@jax.jit
def _ref_update_grads(st, batch, key):
    """The reference update's gradients, by its own loss closures."""
    p = st.params
    k1, k2 = jax.random.split(key)
    alpha = jnp.exp(p.log_alpha)
    a2, _, logp2_c, _, _, _ = ref_nets.sample_actions(p.actor, batch.s2, k1)
    q_next = jnp.minimum(ref_nets.critic_forward(p.q1_targ, batch.s2, a2),
                         ref_nets.critic_forward(p.q2_targ, batch.s2, a2))
    y = batch.r + ref_sac.GAMMA * (1.0 - batch.done) * (q_next
                                                        - alpha * logp2_c)

    def critic_loss(qp):
        q = ref_nets.critic_forward(qp, batch.s, batch.a_cont)
        return jnp.mean(batch.is_w * (q - y) ** 2)

    g1 = jax.grad(critic_loss)(p.q1)
    g2 = jax.grad(critic_loss)(p.q2)
    q1_new, _ = ref_adam_update(p.q1, g1, st.opt.q1, lr=ref_sac.LR,
                                grad_clip=10.0)
    q2_new, _ = ref_adam_update(p.q2, g2, st.opt.q2, lr=ref_sac.LR,
                                grad_clip=10.0)

    def actor_loss(ap):
        a, _, logp_c, _, gate, disc_logits = ref_nets.sample_actions(
            ap, batch.s, k2)
        q_pi = jnp.minimum(ref_nets.critic_forward(q1_new, batch.s, a),
                           ref_nets.critic_forward(q2_new, batch.s, a))
        loss_cont = jnp.mean(alpha * logp_c - q_pi)
        logp_stored = jnp.take_along_axis(
            jax.nn.log_softmax(disc_logits, -1),
            batch.a_disc[..., None], -1).squeeze(-1).sum(-1)
        v_s = jax.lax.stop_gradient(q_pi - alpha * logp_c)
        adv = jax.lax.stop_gradient(batch.r + ref_sac.GAMMA * (1 - batch.done)
                                    * (q_next - alpha * logp2_c) - v_s)
        loss_disc = -jnp.mean(batch.is_w * logp_stored * adv)
        ent = -jnp.mean(jnp.sum(jax.nn.softmax(disc_logits, -1)
                                * jax.nn.log_softmax(disc_logits, -1),
                                axis=(-2, -1)))
        return (loss_cont + 0.5 * loss_disc - 1e-3 * ent
                + ref_nets.moe_balance_loss(gate)), logp_c

    ga, logp_c = jax.grad(actor_loss, has_aux=True)(p.actor)
    g_al = jax.grad(lambda la: -jnp.mean(jnp.exp(la) * jax.lax.stop_gradient(
        logp_c + ref_sac.TARGET_ENTROPY)))(p.log_alpha)
    return dict(q1=g1, q2=g2, actor=ga, log_alpha=jnp.clip(g_al, -1.0, 1.0))


def _update_noise(key):
    k1, k2 = jax.random.split(key)
    kc1, _ = jax.random.split(k1)
    kc2, _ = jax.random.split(k2)
    return sac.UpdateNoise(T(np.asarray(jax.random.normal(kc1, (B, N_CONT)))),
                           T(np.asarray(jax.random.normal(kc2, (B, N_CONT)))))


def test_sac_update_matches_reference():
    st, port = _ref_sac(0)
    bnp = _batch(0)
    key = jax.random.PRNGKey(9)
    rb = ref_sac.Batch(**{k: J(v) for k, v in bnp.items()})
    new_ref, td_ref, met_ref = ref_sac.update(st, rb, key)
    g_ref = _ref_update_grads(st, rb, key)
    new, td, met, g = sac.update(
        port, sac.Batch(**{k: T(v) for k, v in bnp.items()}),
        noise=_update_noise(key), return_grads=True)
    for k in met_ref:
        np.testing.assert_allclose(float(met[k]), float(met_ref[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_ref), rtol=RTOL,
                               atol=ATOL)
    for name in ("q1", "q2", "actor", "log_alpha"):
        _assert_tree_close(g[name], g_ref[name])
    # Adam's first step moves an element by ~lr*sign(g): compare the new
    # parameters where the gradient is above rounding level
    big = lambda tree: jax.tree_util.tree_map(
        lambda x: np.abs(np.asarray(x)) > 1e-6, tree)
    for name in ("q1", "q2", "actor"):
        _assert_tree_close(getattr(new.params, name),
                           getattr(new_ref.params, name), mask=big(g_ref[name]))
    for name, src in (("q1_targ", "q1"), ("q2_targ", "q2")):
        _assert_tree_close(getattr(new.params, name),
                           getattr(new_ref.params, name), mask=big(g_ref[src]))
    np.testing.assert_allclose(float(new.params.log_alpha),
                               float(new_ref.params.log_alpha), rtol=RTOL)
    assert int(new.step) == int(new_ref.step) == 1


def test_surrogate_train_step_and_gate_signals():
    ref_s = ref_sur.Surrogate.create(SAC_STATE_DIM + N_CONT, seed=2)
    port_s = sur.Surrogate(params=convert.tree_to_torch(np_tree(ref_s.params)),
                           opt_state=sur.init_opt(convert.tree_to_torch(
                               np_tree(ref_s.params))))
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (64, SAC_STATE_DIM + N_CONT)).astype(np.float32)
    metrics = np.abs(rng.normal(0, 1, (64, ref_an.M_DIM))).astype(
        np.float32) * 100.0
    for _ in range(3):
        l_ref = ref_s.update(x, metrics)
        l_port = port_s.update(x, metrics)
        np.testing.assert_allclose(l_port, l_ref, rtol=RTOL)
    assert port_s.n_updates == ref_s.n_updates == 3
    np.testing.assert_allclose(port_s.resid_var, ref_s.resid_var, rtol=RTOL)
    _assert_tree_close(port_s.params, ref_s.params, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(
        sur.calib_errors(port_s.params, T(x), T(metrics)).numpy(),
        np.asarray(ref_sur.calib_errors(ref_s.params, J(x), J(metrics))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port_s(x[:4]), ref_s(x[:4]), rtol=RTOL)
    # the gate is host numpy in both: same opening and serde round trip
    g0 = ref_sur.ScreenGate.create(2, 0.5)
    g1 = sur.ScreenGate.create(2, 0.5)
    for errs, t in (([1.0, np.nan], 64), ([0.2, 0.9], 128), ([0.1, 0.1], 192)):
        g0.observe(np.asarray(errs), t)
        g1.observe(np.asarray(errs), t)
        g0.count(64, 4)
        g1.count(64, 4)
    assert g1.to_dict() == g0.to_dict()
    assert sur.ScreenGate.from_dict(g1.to_dict()).to_dict() == g1.to_dict()


def test_world_model_train_step_matches_reference():
    ref_st = ref_wm.create(1)
    port_st = convert.world_model_state(np_tree(ref_st.params))
    rng = np.random.default_rng(6)
    s = rng.normal(0, 1, (64, SAC_STATE_DIM)).astype(np.float32)
    a = rng.uniform(-1, 1, (64, N_CONT)).astype(np.float32)
    s2 = s + 0.1 * rng.normal(0, 1, s.shape).astype(np.float32)
    for _ in range(3):
        ref_st, l_ref = ref_wm.train_step(ref_st, J(s), J(a), J(s2))
        port_st, l_port = wm.train_step(port_st, T(s), T(a), T(s2))
        np.testing.assert_allclose(float(l_port), float(l_ref), rtol=RTOL)
    np.testing.assert_allclose(float(port_st.ema_loss), float(ref_st.ema_loss),
                               rtol=RTOL)
    assert int(port_st.n_updates) == int(ref_st.n_updates) == 3
    assert wm.trained(port_st) == ref_wm.trained(ref_st)
    _assert_tree_close(port_st.params, ref_st.params, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(
        nets.world_model_forward(port_st.params, T(s), T(a)).detach().numpy(),
        np.asarray(ref_nets.world_model_forward(ref_st.params, J(s), J(a))),
        rtol=RTOL, atol=1e-5)


def test_mpc_plan_with_reference_noise():
    st, port = _ref_sac(4)
    wm_p = ref_wm.create(5).params
    sur_p = ref_sur.Surrogate.create(SAC_STATE_DIM + N_CONT, seed=6).params
    nb = 8
    s = np.random.default_rng(8).normal(0, 1, (nb, SAC_STATE_DIM)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(10), nb)
    want = np.stack([np.asarray(ref_mpc.plan(st.params.actor, wm_p, sur_p,
                                             J(s[i]), keys[i]))
                     for i in range(nb)])
    noise = np.stack([np.asarray(jax.random.normal(
        keys[i], (mpc.K_CANDIDATES, N_CONT))) for i in range(nb)])
    got = mpc.plan(port.params.actor, convert.tree_to_torch(np_tree(wm_p)),
                   convert.tree_to_torch(np_tree(sur_p)), T(s),
                   noise=T(noise)).numpy()
    # the same candidate wins: its first action is the same noise draw
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_mpc_rollouts_go_through_the_kernel_wrappers(monkeypatch):
    """Every network call of ``mpc.plan`` goes through a kernel wrapper
    (``actor_moe`` for the actor, ``fused_mlp`` for the surrogate reward
    and the world-model step), never a plain version directly, so on the
    card the rollouts launch the kernels (an earlier ``plan`` called the
    plain actor on card tensors too)."""
    from repro_torch.kernels import actor_moe, policy_mlp
    calls = {"actor": 0, "mlp": 0}
    real_actor, real_mlp = actor_moe.actor_forward, policy_mlp.fused_mlp

    def actor(*a):
        calls["actor"] += 1
        return real_actor(*a)

    def mlp(*a):
        calls["mlp"] += 1
        return real_mlp(*a)

    monkeypatch.setattr(actor_moe, "actor_forward", actor)
    monkeypatch.setattr(policy_mlp, "fused_mlp", mlp)
    g = torch.Generator().manual_seed(0)
    mpc.plan(sac.create(0).params.actor, wm.create(1).params,
             sur.Surrogate.create(SAC_STATE_DIM + N_CONT, seed=2).params,
             torch.randn((3, SAC_STATE_DIM), generator=g), gen=g)
    assert calls == {"actor": 1 + mpc.HORIZON, "mlp": 2 * mpc.HORIZON}
