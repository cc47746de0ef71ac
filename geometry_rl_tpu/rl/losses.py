"""On-policy losses: TRPL (trust-region projected), clipped PPO, and
adaptive KL-penalty PPO.

Pure-functional redesign of
`geometry_rl/algorithms/trust_region_projections/objectives/{trpl,ppo,utils}.py`.
The reference moved dist params GPU->CPU per minibatch for the C++ projection
(trpl.py:241-245); here the projection is XLA, so the whole loss is one fused
jit region. Losses take the already-computed policy outputs (DiagGaussian) so
they stay model-agnostic; the train step closes over the network apply fns.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import gaussian as G
from .gaussian import DiagGaussian
from .projections.base import BaseProjection


class LossInputs(NamedTuple):
    """Per-sample minibatch data (leading batch dim B)."""

    action: jnp.ndarray  # [B, A]
    sample_log_prob: jnp.ndarray  # [B]   log pi_old(a|s) at collection time
    advantage: jnp.ndarray  # [B]
    value_target: jnp.ndarray  # [B]
    old_value: jnp.ndarray  # [B]   V(s) at collection time (for value clip)


def _distance_loss(pred: jnp.ndarray, target: jnp.ndarray, kind: str) -> jnp.ndarray:
    """torchrl `distance_loss` semantics (per-element, no reduction)."""
    diff = pred - target
    if kind == "l2":
        return diff**2
    if kind == "l1":
        return jnp.abs(diff)
    if kind == "smooth_l1":
        absd = jnp.abs(diff)
        return jnp.where(absd < 1.0, 0.5 * diff**2, absd - 0.5)
    raise ValueError(f"Unknown loss_critic_type {kind!r}")


def clipped_value_loss(
    old_value: jnp.ndarray,
    value: jnp.ndarray,
    value_target: jnp.ndarray,
    clip_value: float,
    kind: str = "l2",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pessimistic (max) clipped value loss (objectives/utils.py:5-27).
    Returns (per-sample loss, clip fraction)."""
    base = _distance_loss(value, value_target, kind)
    value_clipped = old_value + jnp.clip(value - old_value, -clip_value, clip_value)
    clipped = _distance_loss(value_clipped, value_target, kind)
    clip_fraction = jnp.mean((clipped > base).astype(value.dtype))
    return jnp.maximum(base, clipped), clip_fraction


def _normalize_advantage(adv: jnp.ndarray) -> jnp.ndarray:
    loc = adv.mean()
    scale = jnp.maximum(adv.std(), 1e-6)
    return (adv - loc) / scale


def _ess(log_weight: jnp.ndarray) -> jnp.ndarray:
    """Effective sample size / batch (trpl.py:294-299,316)."""
    lw = log_weight
    ess = jnp.exp(2.0 * jax.scipy.special.logsumexp(lw) - jax.scipy.special.logsumexp(2.0 * lw))
    return ess / lw.shape[0]


def trpl_loss(
    new_dist: DiagGaussian,
    old_dist: DiagGaussian,
    value: jnp.ndarray,
    inputs: LossInputs,
    projection: BaseProjection,
    step=0,
    initial_entropy=None,
    *,
    entropy_coef: float = 0.005,
    critic_coef: float = 0.5,
    clip_value: float = 0.2,
    loss_critic_type: str = "l2",
    normalize_advantage: bool = True,
    entropy_bonus: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """TRPL objective (objectives/trpl.py:276-321).

    Returns (actor_loss, critic_loss, metrics). actor_loss already includes
    the trust-region penalty and entropy bonus (train.py:296-301 adds them
    before backward); critic_loss is scaled by critic_coef.
    """
    advantage = inputs.advantage
    if normalize_advantage:
        advantage = _normalize_advantage(advantage)

    proj_dist = projection(new_dist, old_dist, step, initial_entropy=initial_entropy)

    log_prob = G.log_prob(proj_dist, inputs.action)
    log_weight = log_prob - inputs.sample_log_prob

    # IS-weighted gain, NO ratio clipping (trpl.py:302)
    gain = jnp.exp(log_weight) * advantage
    loss_objective = -gain.mean()

    trust_region = projection.trust_region_loss(new_dist, proj_dist)

    actor_loss = loss_objective + trust_region
    entropy = G.entropy(proj_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * entropy.mean()

    critic_per_sample, clip_fraction = clipped_value_loss(
        inputs.old_value, value, inputs.value_target, clip_value, loss_critic_type
    )
    critic_loss = critic_coef * critic_per_sample.mean()

    metrics = {
        "loss_objective": loss_objective,
        "loss_trust_region": trust_region,
        "loss_entropy": -entropy_coef * entropy.mean(),
        "loss_critic": critic_loss,
        "entropy": entropy.mean(),
        "ESS": _ess(log_weight),
        "value_clip_fraction": clip_fraction,
        "policy_std": new_dist.std.mean(),
        "policy_std_min": new_dist.std.min(),
    }
    # constraint metrics vs the projected dist (trpl.py:318: p vs proj_p)
    metrics.update(projection.compute_metrics(new_dist, proj_dist))
    return actor_loss, critic_loss, metrics


# Adaptive-beta band for kl_pen_ppo_loss (see clamp note inside the function).
KL_PEN_BETA_MIN = 1e-2
KL_PEN_BETA_MAX = 1e6


def kl_pen_ppo_loss(
    new_dist: DiagGaussian,
    old_dist: DiagGaussian,
    value: jnp.ndarray,
    inputs: LossInputs,
    beta: jnp.ndarray,
    *,
    dtarg: float = 0.01,
    increment: float = 2.0,
    decrement: float = 0.5,
    entropy_coef: float = 0.0,
    critic_coef: float = 1.0,
    clip_value: float | None = None,
    loss_critic_type: str = "l2",
    normalize_advantage: bool = True,
    entropy_bonus: bool = False,
    adapt: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Adaptive KL-penalty PPO — the reference's third registered algorithm
    family (`algorithm.name=kl_ppo`: configs/algorithm/kl_ppo.yaml +
    objective/kl_ppo.yaml, wired in examples/torchrl/builders/agent.py:65-79
    via torchrl's KLPENPPOLoss).

    Surrogate = -(ratio * advantage) + beta * KL(old || new); after the loss
    is formed, beta adapts for the NEXT step: *= `increment` when the batch
    KL exceeds 1.5*dtarg, *= `decrement` when it falls below dtarg/1.5
    (torchrl KLPENPPOLoss.forward semantics). The KL is the exact
    diag-Gaussian closed form — the reference estimates it with
    `samples_mc_kl` Monte-Carlo samples only because torchrl supports
    arbitrary distributions; both dists here are diagonal Gaussians.

    The critic loss is UNclipped by default: the reference's builder does not
    wire clip_value into KLPENPPOLoss (agent.py:66-79), so torchrl's default
    (no value clipping) applies. Returns (actor_loss, critic_loss, new_beta,
    metrics).
    """
    advantage = inputs.advantage
    if normalize_advantage:
        advantage = _normalize_advantage(advantage)

    log_prob = G.log_prob(new_dist, inputs.action)
    log_weight = log_prob - inputs.sample_log_prob

    gain = jnp.exp(log_weight) * advantage
    # mean/cov decomposition: a scalar KL penalty prices mu-movement and
    # sigma-movement in one currency, so WHERE the budget goes is the
    # diagnostic for the flagship plateau (docs/KL_PPO_NOTES.md h1)
    kl_maha_part, kl_cov_part = G.kl_parts(old_dist, new_dist)
    kl_mean = (kl_maha_part + kl_cov_part).mean()
    actor_loss = -gain.mean() + beta * kl_mean

    entropy = G.entropy(new_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * entropy.mean()

    if clip_value is not None:
        critic_per_sample, clip_fraction = clipped_value_loss(
            inputs.old_value, value, inputs.value_target, clip_value, loss_critic_type
        )
    else:
        critic_per_sample = _distance_loss(value, inputs.value_target, loss_critic_type)
        clip_fraction = jnp.zeros(())
    critic_loss = critic_coef * critic_per_sample.mean()

    if adapt:
        new_beta = jnp.where(
            kl_mean > dtarg * 1.5,
            beta * increment,
            jnp.where(kl_mean < dtarg / 1.5, beta * decrement, beta),
        )
    else:
        # kl_beta_interval="iteration": beta is a constant of the whole
        # update phase — the per-minibatch controller is bypassed here and
        # the trainer runs one adapt step per iteration instead.
        new_beta = beta
    # Clamp to a positive band. torchrl adapts an unclamped python float, but
    # here beta lives in fp32 on-device and is multiplied by `decrement` once
    # per MINIBATCH (hundreds of times per iteration): a long low-KL stretch
    # underflows it to exactly 0.0, which is absorbing (0 * increment == 0) —
    # the penalty then vanishes permanently and the unclipped surrogate
    # diverges (measured in a 20M-frame kl_ppo insertion run, beta 0 from iter ~6,
    # KL -> 5e2). The floor keeps recovery fast (~2^16 doublings from 1e-2
    # to a dominating penalty within one epoch); the ceiling prevents inf.
    new_beta = jnp.clip(new_beta, KL_PEN_BETA_MIN, KL_PEN_BETA_MAX)

    metrics = {
        "loss_objective": -gain.mean(),
        "loss_entropy": -entropy_coef * entropy.mean() if entropy_bonus else jnp.zeros(()),
        "loss_critic": critic_loss,
        "entropy": entropy.mean(),
        "ESS": _ess(log_weight),
        "kl": kl_mean,
        "kl_mean_part": kl_maha_part.mean(),
        "kl_cov_part": kl_cov_part.mean(),
        "kl_penalty_beta": beta,
        "kl_penalty_beta_max": beta,
        "value_clip_fraction": clip_fraction,
        "policy_std": new_dist.std.mean(),
        "policy_std_min": new_dist.std.min(),
    }
    return actor_loss, critic_loss, new_beta, metrics


def ppo_clip_loss(
    new_dist: DiagGaussian,
    value: jnp.ndarray,
    inputs: LossInputs,
    *,
    clip_epsilon: float = 0.2,
    entropy_coef: float = 0.005,
    critic_coef: float = 0.5,
    clip_value: float | None = 0.2,
    loss_critic_type: str = "l2",
    normalize_advantage: bool = True,
    entropy_bonus: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Clipped PPO with value clipping (objectives/ppo.py `ClipPPOLoss2`)."""
    advantage = inputs.advantage
    if normalize_advantage:
        advantage = _normalize_advantage(advantage)

    log_prob = G.log_prob(new_dist, inputs.action)
    log_weight = log_prob - inputs.sample_log_prob

    gain1 = jnp.exp(log_weight) * advantage
    log_weight_clip = jnp.clip(log_weight, jnp.log1p(-clip_epsilon), jnp.log1p(clip_epsilon))
    gain2 = jnp.exp(log_weight_clip) * advantage
    gain = jnp.minimum(gain1, gain2)
    loss_objective = -gain.mean()

    actor_loss = loss_objective
    entropy = G.entropy(new_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * entropy.mean()

    if clip_value is not None:
        critic_per_sample, clip_fraction = clipped_value_loss(
            inputs.old_value, value, inputs.value_target, clip_value, loss_critic_type
        )
    else:
        critic_per_sample = _distance_loss(value, inputs.value_target, loss_critic_type)
        clip_fraction = jnp.zeros(())
    critic_loss = critic_coef * critic_per_sample.mean()

    metrics = {
        "loss_objective": loss_objective,
        "loss_entropy": -entropy_coef * entropy.mean(),
        "loss_critic": critic_loss,
        "entropy": entropy.mean(),
        "ESS": _ess(log_weight),
        "clip_fraction": jnp.mean((gain2 < gain1).astype(value.dtype)),
        "value_clip_fraction": clip_fraction,
        "policy_std": new_dist.std.mean(),
        "policy_std_min": new_dist.std.min(),
    }
    return actor_loss, critic_loss, metrics
