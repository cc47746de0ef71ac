"""Running observation normalizers as explicit pytree state.

JAX redesign of the reference's TorchRL transforms
(geometry_rl/torchrl/envs/transforms.py):

- `VecNorm` — per-dimension decayed running mean/variance (torchrl semantics:
  _sum/_ssq/_count with exponential decay, variance clamped by eps).
- `NDVecNorm` (transforms.py:135-171) — identical update rule, but the
  statistics are SHARED across all leading dims beyond the stat shape: for
  geometric observations reshaped to [..., 3], one (3,) statistic normalizes
  every 3-vector, preserving geometry (a single anisotropic affine map).
- `MinMaxNorm` (transforms.py:174-370) — running global min/max scaler.

State lives in the train state (checkpointed with it), so the reference's
fragile env-state-dict merge for restoring normalizer stats
(examples/torchrl/train.py:99-102) disappears by construction. All updates are
pure: `update(state, x) -> new_state`; `normalize(state, x) -> x_norm` is
read-only (frozen stats at eval, like exploration-off rollouts).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


class VecNormState(NamedTuple):
    """Decayed running sums for mean/var normalization. Shapes = stat shape."""

    sum: jnp.ndarray
    ssq: jnp.ndarray
    count: jnp.ndarray  # scalar


def vecnorm_init(stat_shape: tuple, dtype=jnp.float32) -> VecNormState:
    return VecNormState(
        sum=jnp.zeros(stat_shape, dtype),
        ssq=jnp.zeros(stat_shape, dtype),
        count=jnp.zeros((), dtype),
    )


def vecnorm_update(state: VecNormState, x: jnp.ndarray, decay: float = 0.99999) -> VecNormState:
    """Fold a batch into the running stats. All dims of `x` beyond the stat
    shape are reduced (NDVecNorm semantics: N counted across leading dims)."""
    stat_ndim = state.sum.ndim
    reduce_axes = tuple(range(x.ndim - stat_ndim))
    n = 1
    for ax in reduce_axes:
        n *= x.shape[ax]
    return VecNormState(
        sum=state.sum * decay + x.sum(axis=reduce_axes),
        ssq=state.ssq * decay + (x * x).sum(axis=reduce_axes),
        count=state.count * decay + n,
    )


def vecnorm_normalize(state: VecNormState, x: jnp.ndarray, eps: float = 1e-2) -> jnp.ndarray:
    """(x - mean) / sqrt(max(var, eps)) with stats broadcast over leading dims."""
    count = jnp.maximum(state.count, 1.0)
    mean = state.sum / count
    var = state.ssq / count - mean**2
    std = jnp.sqrt(jnp.maximum(var, eps))
    return (x - mean) / std


def vecnorm_mean_std(state: VecNormState, eps: float = 1e-2) -> Tuple[jnp.ndarray, jnp.ndarray]:
    count = jnp.maximum(state.count, 1.0)
    mean = state.sum / count
    var = state.ssq / count - mean**2
    return mean, jnp.sqrt(jnp.maximum(var, eps))


class MinMaxState(NamedTuple):
    min: jnp.ndarray
    max: jnp.ndarray
    count: jnp.ndarray


def minmax_init(stat_shape: tuple, dtype=jnp.float32) -> MinMaxState:
    return MinMaxState(
        min=jnp.zeros(stat_shape, dtype),
        max=jnp.zeros(stat_shape, dtype),
        count=jnp.zeros((), dtype),
    )


def minmax_update(state: MinMaxState, x: jnp.ndarray) -> MinMaxState:
    stat_ndim = state.min.ndim
    reduce_axes = tuple(range(x.ndim - stat_ndim))
    n = 1
    for ax in reduce_axes:
        n *= x.shape[ax]
    return MinMaxState(
        min=jnp.minimum(state.min, x.min(axis=reduce_axes)),
        max=jnp.maximum(state.max, x.max(axis=reduce_axes)),
        count=state.count + n,
    )


def minmax_normalize(state: MinMaxState, x: jnp.ndarray, out_min: float = -1.0, out_max: float = 1.0) -> jnp.ndarray:
    """Scale into [out_min, out_max] by the GLOBAL max range over all stat dims
    (transforms.py:303-304 uses `torch.max(_max - _min)`)."""
    scale = (out_max - out_min) / jnp.maximum(jnp.max(state.max - state.min), 1e-8)
    return (x - state.min) * scale + out_min
