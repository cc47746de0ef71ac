"""Diagonal-Gaussian distribution toolkit.

The policy family in the reference is diagonal-Gaussian only
(`policy_factory.py:28-31` registers just `gnn_diag`); the reference carries
std as diag-embedded matrices, here distributions are `(mean [..., K],
std [..., K])` vectors (no diag_embed round-trips).

Closed forms mirror
`geometry_rl/algorithms/trust_region_projections/models/policy/gnn_gaussian_policy_diag.py:100-137`
and `utils/projection_utils.py:34-67`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussian(NamedTuple):
    """A batch of diagonal Gaussians: mean [..., K], std [..., K] (std > 0)."""

    mean: jnp.ndarray
    std: jnp.ndarray


def log_prob(p: DiagGaussian, x: jnp.ndarray) -> jnp.ndarray:
    """Log density; matches `gnn_gaussian_policy_diag.log_probability`."""
    k = x.shape[-1]
    maha_part = maha(x, p.mean, p.std)
    return -0.5 * (maha_part + k * LOG_2PI + log_determinant(p.std))


def entropy(p: DiagGaussian) -> jnp.ndarray:
    k = p.std.shape[-1]
    return 0.5 * (k * (LOG_2PI + 1.0) + log_determinant(p.std))


def log_determinant(std: jnp.ndarray) -> jnp.ndarray:
    """log det of the covariance (= 2 * sum log std)."""
    return 2.0 * jnp.sum(jnp.log(std), axis=-1)


def maha(x: jnp.ndarray, mean: jnp.ndarray, std: jnp.ndarray) -> jnp.ndarray:
    """Mahalanobis distance ||x - mean||^2_{Sigma^-1} for diag Sigma = std^2."""
    diff = (x - mean) / std
    return jnp.sum(diff * diff, axis=-1)


def sample(key: jax.Array, p: DiagGaussian, shape: tuple = ()) -> jnp.ndarray:
    eps = jax.random.normal(key, tuple(shape) + p.mean.shape, dtype=p.mean.dtype)
    return p.mean + eps * p.std


def kl_parts(p: DiagGaussian, q: DiagGaussian) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean part, cov part) of KL(p || q), matching `gaussian_kl`
    (projection_utils.py:34-67): mean part = 0.5 * maha(mu_p, mu_q, sigma_q);
    cov part = 0.5 * (trace + logdet_q - logdet_p - k)."""
    k = p.mean.shape[-1]
    maha_part = 0.5 * maha(p.mean, q.mean, q.std)
    ratio = (p.std / q.std) ** 2
    cov_part = 0.5 * (jnp.sum(ratio, axis=-1) - k + log_determinant(q.std) - log_determinant(p.std))
    return maha_part, cov_part


def kl(p: DiagGaussian, q: DiagGaussian) -> jnp.ndarray:
    m, c = kl_parts(p, q)
    return m + c


def frobenius_parts(p: DiagGaussian, q: DiagGaussian, scale_prec: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean part, cov part) of the Frobenius divergence
    (projection_utils.py:70-104, diagonal specialization)."""
    if scale_prec:
        mean_part = maha(p.mean, q.mean, q.std)
    else:
        mean_part = jnp.sum((q.mean - p.mean) ** 2, axis=-1)
    diff = q.std**2 - p.std**2
    cov_part = jnp.sum(diff * diff, axis=-1)
    return mean_part, cov_part


def wasserstein_parts(p: DiagGaussian, q: DiagGaussian, scale_prec: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean part, cov part) of the commutative W2 divergence
    (projection_utils.py:107-149, diagonal specialization: sqrt = std)."""
    if scale_prec:
        mean_part = maha(p.mean, q.mean, q.std)
        c = (p.std / q.std) ** 2
        cov_part = jnp.sum(1.0 + c - 2.0 * (p.std / q.std), axis=-1)
    else:
        mean_part = jnp.sum((q.mean - p.mean) ** 2, axis=-1)
        cov_part = jnp.sum(q.std**2 + p.std**2 - 2.0 * q.std * p.std, axis=-1)
    return mean_part, cov_part
