"""PAPI projection (Akrour et al. 2019) — joint-bound expectation projection.

Redesign of `projections/papi_projection.py`: PAPI enforces ONE joint bound
eps = mean_bound + cov_bound on the EXPECTED KL over the batch (not
per-sample), by (1) interpolating the covariance toward the old one
(papi_projection.py:118-131) and (2) scaling the mean update by a factor
eta solving the remaining budget (papi_projection.py:137-153).

The reference additionally interpolates the policy's LAST-LAYER WEIGHTS
in torch (`papi_weight_update`, `_papi_steps` backtracking); the functional
equivalent here is `papi_weight_update(params, intermed_params, eta)` which
callers apply post-update — the distribution-level projection below is what
enters the loss. Diagonal-covariance specialization throughout (the only
registered policy family).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..gaussian import DiagGaussian, entropy, kl_parts
from .base import BaseProjection, entropy_inequality_projection


@dataclasses.dataclass(frozen=True)
class PAPIProjection(BaseProjection):
    """entropy_first is implied (papi_projection.py:38 asserts it)."""

    def _trust_region_projection(self, p: DiagGaussian, q: DiagGaussian, eps, eps_cov) -> DiagGaussian:
        eps_joint = eps + eps_cov  # joint bound (papi_projection.py:100)

        maha_part, cov_part = kl_parts(p, q)
        maha_mean = maha_part.mean()
        cov_mean = cov_part.mean()
        exceeded = maha_mean + cov_mean > eps_joint + 1e-6

        # --- covariance rotation/rescaling (expectation-level) -------------
        var, old_var = p.std**2, q.std**2
        eta_rot = eps_joint / jnp.maximum(maha_mean + cov_mean, 1e-16)
        new_var = jnp.where(exceeded, (1.0 - eta_rot) * old_var + eta_rot * var, var)
        # recompute the cov part of the expected KL for the projected cov
        k = var.shape[-1]
        trace_term = 0.5 * (jnp.sum(new_var / old_var, axis=-1) - k).mean()
        entropy_diff = 0.5 * (jnp.sum(jnp.log(old_var), -1) - jnp.sum(jnp.log(new_var), -1)).mean()
        cov_new = jnp.where(exceeded, trace_term + entropy_diff, cov_mean)

        # --- mean interpolation ---------------------------------------------
        still_exceeded = maha_mean + cov_new > eps_joint + 1e-6
        eta_mean = jnp.sqrt(
            jnp.maximum(eps_joint - cov_new, 1e-16) / jnp.maximum(maha_mean, 1e-16)
        )
        eta_mean = jnp.where(still_exceeded, jnp.minimum(eta_mean, 1.0), 1.0)
        proj_mean = q.mean + eta_mean * (p.mean - q.mean)
        return DiagGaussian(proj_mean, jnp.sqrt(new_var))


def papi_weight_update(params, intermed_params, eta: jnp.ndarray):
    """Functional `papi_weight_update`: interpolate every parameter toward the
    intermediate (pre-update) parameters by eta — the last-layer-only variant
    is obtained by passing trees containing just those leaves."""
    return jax.tree_util.tree_map(lambda new, old: old + eta * (new - old), params, intermed_params)


# ---------------------------------------------------------------------------
# `_papi_steps` backtracking (papi_projection.py:151-245), on-device redesign
# ---------------------------------------------------------------------------
#
# The reference keeps a Python list of deep-copied policies and, after PPO's
# epochs, (1) backtracks to the most recent policy satisfying the expected-KL
# budget, (2) anneals the LR when backtracking goes deep, (3) runs 20 PAPI
# iterations that interpolate the mean head's last-layer weights by the
# line-searched eta and overwrite the (non-contextual) std with the projected
# one [Akrour et al. 2019, Alg. 2].
#
# Redesign notes:
# - The history is a FIXED-SIZE ring buffer stacked as a pytree with leading
#   axis H (most recent first) so the whole procedure — feasibility scan,
#   candidate gather, 20 PAPI iterations — is one jittable XLA program with
#   `lax.map`/`fori_loop` instead of data-dependent Python control flow.
# - The reference's in-place loop updates the INTERMEDIATE policy's weight
#   toward its own saved copy (`W <- eta*W + (1-eta)*A` with W starting at A,
#   papi_projection.py:225-243), which leaves the mean unchanged — a latent
#   bug in a path their train.py never exercises. We implement the
#   mathematically-intended Alg. 2: start from the CURRENT (post-PPO) head on
#   the intermediate trunk and contract it toward the feasible head, so eta
#   is meaningful. The bias is interpolated along with the kernel so the
#   linear-interpolation identity `mu <- mu_int + eta (mu - mu_int)` is exact.
# - The reference's cross-term `b` is computed as an outer-product mean over
#   sample PAIRS (papi_projection.py:146); we use the per-sample expectation
#   the derivation intends.


class PAPIState(NamedTuple):
    """Cross-iteration PAPI carry (the reference's `last_policies` + LR)."""

    history: Any  # actor-params pytree stacked [H, ...], most recent first
    hist_len: jnp.ndarray  # number of valid entries (int32)
    lr_scale: jnp.ndarray  # multiplicative LR annealing state (f32)


def papi_init_state(params, history: int = 8) -> PAPIState:
    """Ring buffer seeded with broadcast copies of the initial params (masked
    out by hist_len until real entries are pushed)."""
    stacked = jax.tree_util.tree_map(lambda p: jnp.broadcast_to(p[None], (history,) + p.shape).copy(), params)
    return PAPIState(history=stacked, hist_len=jnp.zeros((), jnp.int32), lr_scale=jnp.ones(()))


def find_papi_paths(params) -> Tuple[Tuple, Tuple, Tuple]:
    """Locate (mean kernel, mean bias, pre_std) key paths in an actor params
    tree. Requires a Dense mean head named 'mean' and a NON-contextual std
    parameter 'pre_std' (papi_projection.py:173 asserts not contextual_std)."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    kernel = bias = pre_std = None
    for path, leaf in leaves:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        if keys[-2:] == ("mean", "kernel"):
            kernel = keys
        elif keys[-2:] == ("mean", "bias"):
            bias = keys
        elif keys[-1] == "pre_std" or (len(keys) >= 2 and keys[-2] == "pre_std"):
            if keys[-1] != "pre_std" or leaf.ndim != 1:
                raise ValueError(
                    "PAPI steps require a non-contextual std (pre_std must be a "
                    "1-D parameter; got a contextual std head). Build the policy "
                    "with contextual_std=False."
                )
            pre_std = keys
    if kernel is None or bias is None or pre_std is None:
        raise ValueError(
            "PAPI steps need a Dense mean head named 'mean' and a 'pre_std' "
            f"parameter; found kernel={kernel}, bias={bias}, pre_std={pre_std}."
        )
    return kernel, bias, pre_std


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_set(tree, path, value):
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _tree_set(tree[path[0]], path[1:], value)
    return out


def papi_project_with_intermed(
    p: DiagGaussian,
    q: DiagGaussian,
    intermed_mean: jnp.ndarray,
    eps_joint,
    entropy_bound,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One PAPI projection step with an intermediate mean
    (papi_projection.py:64-157, diagonal specialization): entropy-first
    inequality projection, expectation-level covariance rotation toward the
    old cov, then the quadratic eta line search pulling the mean toward
    `intermed_mean`. Returns (eta_mean scalar, projected std row [A])."""
    p = entropy_inequality_projection(p, entropy_bound)
    var, old_var = p.std**2, q.std**2

    maha_part, cov_part = kl_parts(p, q)
    maha_part, cov_part = maha_part.mean(), cov_part.mean()
    prec = 1.0 / old_var
    maha_inter = 0.5 * jnp.sum((intermed_mean - q.mean) ** 2 * prec, axis=-1).mean()
    mm = jnp.minimum(maha_part, maha_inter)

    exceeded = maha_part + cov_part > eps_joint + 1e-6
    eta_rot = (eps_joint - mm) / jnp.maximum(maha_part + cov_part, 1e-16)
    new_var = jnp.where(exceeded, (1.0 - eta_rot) * old_var + eta_rot * var, var)
    k = p.mean.shape[-1]
    trace_term = 0.5 * (jnp.sum(new_var / old_var, axis=-1) - k).mean()
    entropy_diff = 0.5 * (jnp.sum(jnp.log(old_var), -1) - jnp.sum(jnp.log(new_var), -1)).mean()
    cov_new = jnp.where(exceeded, trace_term + entropy_diff, cov_part)

    still = maha_part + cov_new > eps_joint + 1e-6
    a = 0.5 * jnp.sum((p.mean - intermed_mean) ** 2 * prec, axis=-1).mean()
    b = 0.5 * jnp.sum((p.mean - intermed_mean) * (intermed_mean - q.mean) * prec, axis=-1).mean()
    c = maha_inter - jnp.maximum(eps_joint - cov_new, 0.0)
    eta_q = (-b + jnp.sqrt(jnp.maximum(b * b - a * c, 1e-16))) / jnp.maximum(a, 1e-16)
    # the quadratic can yield eta outside [0, 1] when the intermediate itself
    # (nearly) exhausts the budget (c > 0, b > 0); interpolation toward the
    # feasible head must never extrapolate, so clamp like PAPIProjection does
    eta_mean = jnp.where(still, jnp.clip(eta_q, 0.0, 1.0), 1.0)
    # non-contextual: all rows of the projected std are identical — return row 0
    std_row = jnp.sqrt(new_var.reshape(-1, new_var.shape[-1])[0])
    return eta_mean, std_row


def papi_steps(
    apply_fn: Callable[[Any], DiagGaussian],
    params,
    papi: PAPIState,
    q: DiagGaussian,
    mean_bound: float,
    cov_bound: float,
    initial_entropy: jnp.ndarray,
    *,
    init_std: float = 1.0,
    minimal_std: float = 1e-5,
    n_iters: int = 20,
    anneal_after: int = 4,
) -> Tuple[Any, PAPIState, jnp.ndarray, jnp.ndarray]:
    """Post-update PAPI backtracking + projection (papi_projection.py:151-245).

    apply_fn(params) -> DiagGaussian over the collected observations (the
    caller closes over obs / graph building). Returns
    (new_params, new_papi_state_without_lr_update, anneal_lr flag,
    n_backtracks) — the caller applies its own LR annealing policy when
    `anneal_lr` is set (the reference steps its torch lr_schedule).
    """
    eps_joint = mean_bound + cov_bound
    k_path, b_path, s_path = find_papi_paths(params)
    hist_size = jax.tree_util.tree_leaves(papi.history)[0].shape[0]

    # candidates: current params first, then the ring buffer (most recent first)
    candidates = jax.tree_util.tree_map(
        lambda p, h: jnp.concatenate([p[None], h], axis=0), params, papi.history
    )

    def expected_kl(cand):
        d = apply_fn(cand)
        m, c = kl_parts(d, q)
        return m.mean() + c.mean()

    # First feasible (most recent) candidate via an early-exiting while_loop:
    # in the common case candidate 0 (the current policy) is already feasible
    # and exactly ONE full-batch forward is paid, vs H+1 for a lax.map scan
    # (the reference's Python loop also stops at the first feasible policy).
    def kl_at(i):
        cand = jax.tree_util.tree_map(lambda x: x[i], candidates)
        return expected_kl(cand)

    def scan_cond(carry):
        i, feas = carry
        return ~feas & (i <= papi.hist_len)

    def scan_step(carry):
        i, _ = carry
        feas = kl_at(i) <= eps_joint
        return jnp.where(feas, i, i + 1), feas

    idx, found = jax.lax.while_loop(
        scan_cond, scan_step, (jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    )
    anneal_lr = (idx >= anneal_after) | ~found
    # when nothing is feasible idx = hist_len + 1 (reported as n_backtracks so
    # the not-found case is distinguishable from "current policy feasible");
    # clamp only for the gather below — new_params falls back to `params`.
    gather_idx = jnp.minimum(idx, hist_size)

    intermed = jax.tree_util.tree_map(lambda x: x[gather_idx], candidates)
    intermed_mean = jax.lax.stop_gradient(apply_fn(intermed).mean)
    a_kernel = _tree_get(intermed, k_path)
    a_bias = _tree_get(intermed, b_path)

    # start: current mean head on the intermediate trunk (Alg. 2's A @ phi(s))
    working = _tree_set(intermed, k_path, _tree_get(params, k_path))
    working = _tree_set(working, b_path, _tree_get(params, b_path))

    # entropy gate (papi_projection.py:229-234)
    ent = entropy(q).mean()
    entropy_bound = jnp.where(
        ent / initial_entropy > 0.5, -jnp.inf, ent - eps_joint
    )
    shift = jnp.log(jnp.expm1(jnp.asarray(init_std - minimal_std)))

    def body(_, working):
        p = apply_fn(working)
        eta, std_row = papi_project_with_intermed(p, q, intermed_mean, eps_joint, entropy_bound)
        new_k = eta * _tree_get(working, k_path) + (1.0 - eta) * a_kernel
        new_b = eta * _tree_get(working, b_path) + (1.0 - eta) * a_bias
        pre = jnp.log(jnp.expm1(jnp.maximum(std_row - minimal_std, 1e-8))) - shift
        working = _tree_set(working, k_path, new_k)
        working = _tree_set(working, b_path, new_b)
        working = _tree_set(working, s_path, pre.astype(_tree_get(working, s_path).dtype))
        return working

    working = jax.lax.fori_loop(0, n_iters, body, working)

    # no feasible candidate: keep the (poor) current policy, don't push it
    # (papi_projection.py:207-215 pops the just-appended policy)
    new_params = jax.tree_util.tree_map(lambda w, p: jnp.where(found, w, p), working, params)
    new_history = jax.tree_util.tree_map(
        lambda h, p: jnp.where(found, jnp.roll(h, 1, axis=0).at[0].set(p), h),
        papi.history,
        params,
    )
    new_len = jnp.where(found, jnp.minimum(papi.hist_len + 1, hist_size), papi.hist_len)
    new_state = PAPIState(history=new_history, hist_len=new_len.astype(jnp.int32), lr_scale=papi.lr_scale)
    return new_params, new_state, anneal_lr, idx
