"""Tests for GAE, normalizers, and the TRPL / PPO losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometry_rl_tpu.rl import gaussian as G
from geometry_rl_tpu.rl.gae import gae
from geometry_rl_tpu.rl.losses import (
    LossInputs,
    clipped_value_loss,
    kl_pen_ppo_loss,
    ppo_clip_loss,
    trpl_loss,
)
from geometry_rl_tpu.rl.normalizer import (
    minmax_init,
    minmax_normalize,
    minmax_update,
    vecnorm_init,
    vecnorm_mean_std,
    vecnorm_normalize,
    vecnorm_update,
)
from geometry_rl_tpu.rl.projections import KLProjection


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------


def np_gae(rewards, values, dones, bootstrap, gamma, lam):
    T, E = rewards.shape
    next_values = np.concatenate([values[1:], bootstrap[None]], 0)
    nd = 1.0 - dones
    deltas = rewards + gamma * next_values * nd - values
    adv = np.zeros_like(rewards)
    acc = np.zeros(E)
    for t in reversed(range(T)):
        acc = deltas[t] + gamma * lam * nd[t] * acc
        adv[t] = acc
    return adv, adv + values


def test_gae_golden():
    rng = np.random.default_rng(0)
    T, E = 20, 4
    rewards = rng.normal(size=(T, E)).astype(np.float32)
    values = rng.normal(size=(T, E)).astype(np.float32)
    dones = (rng.uniform(size=(T, E)) < 0.1).astype(np.float32)
    bootstrap = rng.normal(size=(E,)).astype(np.float32)
    adv, tgt = gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones), jnp.asarray(bootstrap), 0.99, 0.95)
    adv_ref, tgt_ref = np_gae(rewards, values, dones, bootstrap, 0.99, 0.95)
    np.testing.assert_allclose(adv, adv_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tgt, tgt_ref, rtol=1e-4, atol=1e-5)


def test_gae_constant_reward_no_done():
    # With constant reward r, V=0 everywhere: A_t = r * sum_{i} (gamma*lam)^i
    T, E = 50, 2
    r = 1.0
    adv, _ = gae(
        jnp.full((T, E), r),
        jnp.zeros((T, E)),
        jnp.zeros((T, E)),
        jnp.zeros((E,)),
        0.99,
        0.95,
    )
    gl = 0.99 * 0.95
    expected_last = r  # only one delta at the end
    np.testing.assert_allclose(adv[-1], expected_last, rtol=1e-5)
    expected_first = r * (1 - gl**T) / (1 - gl)
    np.testing.assert_allclose(adv[0], expected_first, rtol=1e-4)


def test_gae_resets_at_done():
    T, E = 10, 1
    dones = np.zeros((T, E), np.float32)
    dones[4] = 1.0
    adv, _ = gae(
        jnp.ones((T, E)),
        jnp.zeros((T, E)),
        jnp.asarray(dones),
        jnp.zeros((E,)) + 100.0,  # bootstrap ignored before the done
        0.99,
        0.95,
    )
    # advantage at t=4 sees only its own reward (episode boundary)
    np.testing.assert_allclose(adv[4], 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------


def test_vecnorm_converges_to_moments():
    rng = np.random.default_rng(3)
    state = vecnorm_init((3,))
    data = (rng.normal(size=(200, 64, 3)) * np.array([2.0, 0.5, 1.0]) + np.array([1.0, -1.0, 0.0])).astype(np.float32)
    for i in range(200):
        state = vecnorm_update(state, jnp.asarray(data[i]), decay=1.0)
    mean, std = vecnorm_mean_std(state, eps=1e-8)
    np.testing.assert_allclose(mean, [1.0, -1.0, 0.0], atol=0.05)
    np.testing.assert_allclose(std, [2.0, 0.5, 1.0], atol=0.05)
    out = vecnorm_normalize(state, jnp.asarray(data[0]), eps=1e-8)
    assert abs(float(out.mean())) < 0.1


def test_vecnorm_shared_stats_over_nodes():
    """NDVecNorm semantics: a [B, N, 3] batch updates a single (3,) stat."""
    state = vecnorm_init((3,))
    x = jnp.ones((8, 10, 3))
    state = vecnorm_update(state, x)
    assert float(state.count) == 80.0
    assert state.sum.shape == (3,)


def test_vecnorm_eps_floors_variance():
    state = vecnorm_init((2,))
    x = jnp.ones((100, 2))  # zero variance
    state = vecnorm_update(state, x)
    out = vecnorm_normalize(state, x, eps=1e-2)
    assert np.isfinite(np.asarray(out)).all()
    np.testing.assert_allclose(out, 0.0, atol=1e-4)


def test_minmax_norm():
    state = minmax_init((2,))
    x = jnp.asarray(np.array([[0.0, 5.0], [10.0, -5.0]], np.float32))
    state = minmax_update(state, x)
    out = minmax_normalize(state, x, -1.0, 1.0)
    assert float(out.max()) <= 1.0 + 1e-6 and float(out.min()) >= -1.0 - 1e-6


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


B, A = 32, 6


@pytest.fixture
def loss_data():
    rng = np.random.default_rng(7)
    mean = rng.normal(size=(B, A)).astype(np.float32)
    std = np.exp(rng.normal(scale=0.2, size=(B, A))).astype(np.float32)
    old_mean = mean + 0.05 * rng.normal(size=(B, A)).astype(np.float32)
    old_std = std * np.exp(0.05 * rng.normal(size=(B, A))).astype(np.float32)
    new_dist = G.DiagGaussian(jnp.asarray(mean), jnp.asarray(std))
    old_dist = G.DiagGaussian(jnp.asarray(old_mean), jnp.asarray(old_std))
    action = np.asarray(old_mean + old_std * rng.normal(size=(B, A))).astype(np.float32)
    inputs = LossInputs(
        action=jnp.asarray(action),
        sample_log_prob=G.log_prob(old_dist, jnp.asarray(action)),
        advantage=jnp.asarray(rng.normal(size=(B,)).astype(np.float32)),
        value_target=jnp.asarray(rng.normal(size=(B,)).astype(np.float32)),
        old_value=jnp.asarray(rng.normal(size=(B,)).astype(np.float32)),
    )
    value = jnp.asarray(rng.normal(size=(B,)).astype(np.float32))
    return new_dist, old_dist, value, inputs


def test_clipped_value_loss_pessimistic():
    old_v = jnp.zeros((4,))
    v = jnp.asarray([0.0, 0.5, 1.0, -1.0])
    tgt = jnp.asarray([0.0, 0.0, 0.0, 0.0])
    loss, _ = clipped_value_loss(old_v, v, tgt, clip_value=0.2)
    # pessimistic: clipped prediction can only increase the loss
    base = (v - tgt) ** 2
    assert (np.asarray(loss) >= np.asarray(base) - 1e-6).all()


def test_trpl_loss_runs_and_is_finite(loss_data):
    new_dist, old_dist, value, inputs = loss_data
    proj = KLProjection(mean_bound=0.05, cov_bound=0.0025, trust_region_coeff=1.0)
    actor_loss, critic_loss, metrics = trpl_loss(new_dist, old_dist, value, inputs, proj)
    assert np.isfinite(float(actor_loss)) and np.isfinite(float(critic_loss))
    assert 0.0 < float(metrics["ESS"]) <= 1.0 + 1e-5
    assert float(metrics["mean_constraint"]) <= 0.05 * 1.05


def test_trpl_loss_grads_finite(loss_data):
    new_dist, old_dist, value, inputs = loss_data
    proj = KLProjection(mean_bound=0.05, cov_bound=0.0025)

    @jax.jit
    def total(mean, std, v):
        a, c, _ = trpl_loss(G.DiagGaussian(mean, std), old_dist, v, inputs, proj)
        return a + c

    g = jax.grad(total, argnums=(0, 1, 2))(new_dist.mean, new_dist.std, value)
    for gi in g:
        assert np.isfinite(np.asarray(gi)).all()


def test_trpl_identical_dists_zero_objective_grad_direction(loss_data):
    """With new == old dist and zero advantage the policy gain is zero."""
    _, old_dist, value, inputs = loss_data
    proj = KLProjection(mean_bound=0.05, cov_bound=0.0025)
    inputs = inputs._replace(advantage=jnp.zeros_like(inputs.advantage))
    actor_loss, _, metrics = trpl_loss(old_dist, old_dist, value, inputs, proj, entropy_bonus=False)
    # objective = -(1 * 0).mean() = 0; trust region loss ~ 0
    assert abs(float(metrics["loss_objective"])) < 1e-5
    assert abs(float(metrics["loss_trust_region"])) < 1e-6


def test_ppo_clip_loss(loss_data):
    new_dist, _, value, inputs = loss_data
    actor_loss, critic_loss, metrics = ppo_clip_loss(new_dist, value, inputs)
    assert np.isfinite(float(actor_loss)) and np.isfinite(float(critic_loss))
    assert 0.0 <= float(metrics["clip_fraction"]) <= 1.0


def test_ppo_clip_reduces_gain():
    """Large ratio with positive advantage must be clipped."""
    mean = jnp.zeros((4, 2))
    std = jnp.ones((4, 2))
    dist = G.DiagGaussian(mean, std)
    action = jnp.zeros((4, 2))
    inputs = LossInputs(
        action=action,
        sample_log_prob=G.log_prob(dist, action) - 2.0,  # ratio = e^2 >> 1+eps
        advantage=jnp.ones((4,)),
        value_target=jnp.zeros((4,)),
        old_value=jnp.zeros((4,)),
    )
    _, _, metrics = ppo_clip_loss(dist, jnp.zeros((4,)), inputs, normalize_advantage=False)
    assert float(metrics["clip_fraction"]) == 1.0


def test_kl_pen_ppo_loss_basic(loss_data):
    """kl_ppo (torchrl KLPENPPOLoss semantics): finite losses, exact KL metric."""
    new_dist, old_dist, value, inputs = loss_data
    beta = jnp.ones(())
    actor_loss, critic_loss, new_beta, metrics = kl_pen_ppo_loss(
        new_dist, old_dist, value, inputs, beta
    )
    assert np.isfinite(float(actor_loss)) and np.isfinite(float(critic_loss))
    assert float(metrics["kl"]) >= 0.0
    assert float(metrics["kl_penalty_beta"]) == 1.0
    # exact closed form, matches G.kl directly
    np.testing.assert_allclose(float(metrics["kl"]), float(G.kl(old_dist, new_dist).mean()), rtol=1e-6)


def test_kl_pen_beta_adapts():
    """beta *= increment above 1.5*dtarg, *= decrement below dtarg/1.5,
    unchanged inside the band (KLPENPPOLoss.forward)."""
    n, d = 16, 3
    mean = jnp.zeros((n, d))
    std = jnp.ones((n, d))
    old = G.DiagGaussian(mean, std)
    action = jnp.zeros((n, d))
    inputs = LossInputs(
        action=action,
        sample_log_prob=G.log_prob(old, action),
        advantage=jnp.ones((n,)),
        value_target=jnp.zeros((n,)),
        old_value=jnp.zeros((n,)),
    )
    value = jnp.zeros((n,))
    beta = jnp.asarray(2.0)

    # far-away new dist -> KL huge -> beta doubles
    far = G.DiagGaussian(mean + 3.0, std)
    _, _, b_up, _ = kl_pen_ppo_loss(far, old, value, inputs, beta, dtarg=0.01)
    assert float(b_up) == 4.0
    # identical dists -> KL 0 < dtarg/1.5 -> beta halves
    _, _, b_dn, _ = kl_pen_ppo_loss(old, old, value, inputs, beta, dtarg=0.01)
    assert float(b_dn) == 1.0
    # in-band KL -> unchanged. KL per dim = 0.5*delta^2; pick delta so
    # mean KL ~ dtarg exactly: KL = 0.5 * 3 * delta^2 = 0.01 -> delta=0.0816
    mid = G.DiagGaussian(mean + 0.0816, std)
    _, _, b_mid, m = kl_pen_ppo_loss(mid, old, value, inputs, beta, dtarg=0.01)
    assert 0.01 / 1.5 < float(m["kl"]) < 0.015
    assert float(b_mid) == 2.0

    # adapt=False (kl_beta_interval="iteration"): the per-minibatch
    # controller is bypassed — beta comes back unchanged even for
    # far-out-of-band KL, and the losses match the adapt=True call.
    al_t, cl_t, _, _ = kl_pen_ppo_loss(far, old, value, inputs, beta, dtarg=0.01)
    al_f, cl_f, b_const, _ = kl_pen_ppo_loss(far, old, value, inputs, beta, dtarg=0.01, adapt=False)
    assert float(b_const) == 2.0
    assert float(al_f) == float(al_t) and float(cl_f) == float(cl_t)


def test_kl_pen_beta_cannot_underflow_to_absorbing_zero():
    """Regression (a 20M-frame kl_ppo insertion run): beta is halved once per
    MINIBATCH; a long low-KL stretch in fp32 underflowed it to exactly 0.0,
    which is absorbing (0*increment == 0) — the penalty vanished permanently
    and the unclipped surrogate diverged (KL -> 5e2). beta must stay in
    [KL_PEN_BETA_MIN, KL_PEN_BETA_MAX] and recover upward from the floor."""
    from geometry_rl_tpu.rl.losses import KL_PEN_BETA_MAX, KL_PEN_BETA_MIN

    n, d = 16, 3
    mean = jnp.zeros((n, d))
    std = jnp.ones((n, d))
    old = G.DiagGaussian(mean, std)
    action = jnp.zeros((n, d))
    inputs = LossInputs(
        action=action,
        sample_log_prob=G.log_prob(old, action),
        advantage=jnp.ones((n,)),
        value_target=jnp.zeros((n,)),
        old_value=jnp.zeros((n,)),
    )
    value = jnp.zeros((n,))

    # 600 consecutive low-KL minibatches (more halvings than fp32 can hold)
    beta = jnp.asarray(1.0, dtype=jnp.float32)
    for _ in range(600):
        _, _, beta, _ = kl_pen_ppo_loss(old, old, value, inputs, beta, dtarg=0.01)
    assert float(beta) == float(np.float32(KL_PEN_BETA_MIN)) > 0.0

    # one high-KL stretch recovers it geometrically (not stuck at the floor)
    far = G.DiagGaussian(mean + 3.0, std)
    for _ in range(40):
        _, _, beta, _ = kl_pen_ppo_loss(far, old, value, inputs, beta, dtarg=0.01)
    assert float(beta) > 1e3

    # and the ceiling holds under unbounded growth
    for _ in range(100):
        _, _, beta, _ = kl_pen_ppo_loss(far, old, value, inputs, beta, dtarg=0.01)
    assert float(beta) == float(np.float32(KL_PEN_BETA_MAX)) and np.isfinite(float(beta))


def test_kl_pen_penalty_direction():
    """The beta*KL term must penalize moving away from the old policy:
    grad of the actor loss w.r.t. the new mean grows with beta."""
    n, d = 8, 2
    old = G.DiagGaussian(jnp.zeros((n, d)), jnp.ones((n, d)))
    action = jnp.zeros((n, d))
    inputs = LossInputs(
        action=action,
        sample_log_prob=G.log_prob(old, action),
        advantage=jnp.zeros((n,)),  # isolate the KL term
        value_target=jnp.zeros((n,)),
        old_value=jnp.zeros((n,)),
    )

    def actor(mean_shift, beta):
        new = G.DiagGaussian(jnp.full((n, d), mean_shift), jnp.ones((n, d)))
        a, _, _, _ = kl_pen_ppo_loss(
            new, old, jnp.zeros((n,)), inputs, jnp.asarray(beta), normalize_advantage=False
        )
        return a

    g1 = float(jax.grad(actor)(0.5, 1.0))
    g4 = float(jax.grad(actor)(0.5, 4.0))
    assert g1 > 0  # pushes back toward the old mean
    assert abs(g4 / g1 - 4.0) < 1e-4  # scales linearly with beta
