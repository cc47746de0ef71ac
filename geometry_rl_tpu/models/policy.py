"""Diagonal-Gaussian graph policy heads.

JAX redesign of
`geometry_rl/algorithms/trust_region_projections/models/policy/
{abstract_gnn_gaussian_policy,gnn_gaussian_policy_diag}.py`:

- `post_fc=False` (HEPi / EMPN): the backbone's equivariant vector output IS
  the action mean (gnn_gaussian_policy_diag.py:66-68); std head reads the
  invariant latent.
- `post_fc=True` (Transformer / GCN): mean = Dense(latent)
  (gnn_gaussian_policy_diag.py:79-83).
- `per_actuator_heads` (two-agent tasks, action_dim list): separate mean/std
  heads per actuator (abstract_gnn_gaussian_policy.py:57-74).
- std = softplus(pre_std + shift) + minimal_std with
  shift = softplus^-1(init_std - minimal_std)
  (abstract_gaussian_policy `_get_preactivation_shift` semantics).

Returns a `DiagGaussian(mean [B, A], std [B, A])`.
"""

from __future__ import annotations

import math
from typing import Callable

from . import nn
import jax.numpy as jnp

from ..graphs.types import GraphFeatures, HeteroGraph
from ..rl.gaussian import DiagGaussian


def inverse_softplus(x: float) -> float:
    """softplus^-1 for the std pre-activation shift (torch_utils.py:361)."""
    return math.log(math.expm1(x)) if x < 20.0 else x


def make_std_fn(init_std: float, minimal_std: float, max_std=None) -> Callable:
    """Std-head activation `pre -> std`.

    max_std=None reproduces the reference parametrization exactly:
    std = softplus(pre + shift) + minimal_std with
    shift = softplus^-1(init_std - minimal_std)
    (abstract_gaussian_policy._get_preactivation_shift).

    max_std=<float> smoothly caps the per-dim std in (minimal_std, max_std):
    std = minimal_std + span * tanh(softplus(pre + shift') / span). This is a
    measured improvement over the reference, not a port: per-dim std extremes
    are the root cause of the two-agents TRPL instability (the entropy bound
    constrains only the TOTAL entropy, so reward-irrelevant dims absorb the
    entropy budget with sigma >> the env's +-1 action clamp while critical
    dims collapse, making the mean-KL 1/sigma^2-stiff —
    docs/diag_two_agents_spike.json). shift' preserves std(0) == init_std
    exactly.
    """
    if max_std is None:
        shift = inverse_softplus(init_std - minimal_std)

        def std_fn(pre):
            return nn.softplus(pre + shift) + minimal_std

        return std_fn

    if not (minimal_std < init_std < max_std):
        raise ValueError(f"need minimal_std < init_std < max_std, got {minimal_std}, {init_std}, {max_std}")
    span = max_std - minimal_std
    shift = inverse_softplus(span * math.atanh((init_std - minimal_std) / span))

    def std_fn(pre):
        return span * jnp.tanh(nn.softplus(pre + shift) / span) + minimal_std

    return std_fn


class DiagGaussianPolicy(nn.Module):
    backbone: nn.Module
    action_dim: int  # TOTAL action dimension
    num_actuators: int = 1
    share_action_dim: bool = True
    per_actuator_heads: bool = False
    contextual_std: bool = True
    post_fc: bool = True
    init_std: float = 1.0
    minimal_std: float = 1e-5
    max_std: float | None = None  # smooth per-dim std cap (see make_std_fn)
    use_tanh_mean: bool = False
    head_init: Callable = nn.initializers.orthogonal(scale=0.01)

    @nn.compact
    def __call__(self, graph: HeteroGraph, feats: GraphFeatures, **backbone_kwargs) -> DiagGaussian:
        out = self.backbone(graph, feats, **backbone_kwargs)
        out, hidden = out  # (vector_out, latent) — all backbones return both
        B = hidden.shape[0]
        G = hidden.shape[1]
        std_from_pre = make_std_fn(self.init_std, self.minimal_std, self.max_std)

        if self.per_actuator_heads:
            a_dim = self.action_dim // self.num_actuators
            means, stds = [], []
            for i in range(self.num_actuators):
                h_i = hidden[:, i]
                m = nn.Dense(a_dim, kernel_init=self.head_init, name=f"mean_{i}")(h_i)
                if self.contextual_std:
                    pre = nn.Dense(a_dim, kernel_init=self.head_init, name=f"pre_std_{i}")(h_i)
                else:
                    pre = self.param(f"pre_std_{i}", nn.initializers.normal(0.01), (a_dim,))
                    pre = jnp.broadcast_to(pre, (B, a_dim))
                means.append(m)
                stds.append(std_from_pre(pre))
            mean = jnp.concatenate(means, axis=-1)
            std = jnp.concatenate(stds, axis=-1)
        else:
            a_dim = self.action_dim // self.num_actuators if self.share_action_dim else self.action_dim
            if self.post_fc:
                mean = nn.Dense(a_dim, kernel_init=self.head_init, name="mean")(hidden)  # [B,G,a]
            else:
                mean = out.reshape(B, G, -1)  # equivariant vector output is the mean
            if self.contextual_std:
                pre = nn.Dense(a_dim, kernel_init=self.head_init, name="pre_std")(hidden)  # [B,G,a]
            else:
                pre = self.param("pre_std", nn.initializers.normal(0.01), (a_dim,))
                pre = jnp.broadcast_to(pre, (B, G, a_dim))
            mean = mean.reshape(B, -1)
            std = std_from_pre(pre).reshape(B, -1)

        if self.use_tanh_mean:
            mean = jnp.tanh(mean)
        return DiagGaussian(mean, std)
