"""Flat (non-graph) observation pipeline — the MLP agent family's data layer.

JAX equivalent of the reference's flat-MLP builder path
(`examples/torchrl/builders/utils_algo.py:27-203`,
`_make_trpl_probabilistic_actor` over plain MLP Gaussian policies with
in_keys=["observation"]): instead of assembling a heterogeneous graph, the
transformed observation groups are flattened and concatenated into one
feature vector. Plugs into the Trainer through the same `build()` protocol
as the graph builders, returning `(None, flat_obs)`.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

# normalized groups, in a fixed feature order (the reference's VecNorm'd
# flattened observation); `infos` carries graph-only integer metadata and is
# excluded, as are the raw un-normalized vector copies
FLAT_GROUPS = ("scalars", "norm_position_vectors", "norm_velocity_vectors")


class FlatObsBuilder:
    """build(tobs) -> (None, [..., D]) flat features for MLP policies/critics."""

    def __init__(self, training_noise: bool = False, training_noise_std: float = 1e-2):
        self.training_noise = training_noise
        self.training_noise_std = training_noise_std

    @classmethod
    def from_env(cls, env, dist_as_pos: bool = True, **kw):
        kw.pop("full_graph_obs", None)  # graph-only option
        return cls(**kw)

    def build(
        self,
        tobs: Dict[str, jnp.ndarray],
        env_ids: Optional[jnp.ndarray] = None,
        noise_key: Optional[jax.Array] = None,
    ):
        del env_ids  # no per-env static topology to gather
        parts = []
        for g in FLAT_GROUPS:
            x = tobs[g]
            x = x.reshape(x.shape[:1] + (-1,))
            if noise_key is not None and self.training_noise and g != "scalars":
                noise_key, k = jax.random.split(noise_key)
                x = x + self.training_noise_std * jax.random.normal(k, x.shape, x.dtype)
            parts.append(x)
        return None, jnp.concatenate(parts, axis=-1)
