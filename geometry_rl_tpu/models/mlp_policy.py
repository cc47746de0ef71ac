"""Flat-observation MLP agents — the non-graph baseline family.

JAX redesign of `examples/torchrl/builders/utils_algo.py:27-203`
(`_make_probabilistic_actor` / `_make_trpl_probabilistic_actor`): a plain MLP
over the flattened normalized observation with the same diagonal-Gaussian
head semantics as the graph policies (softplus+shift std, minimal_std —
abstract_gaussian_policy.py:124-134). Consumes `(graph=None, obs)` from
`graphs.flat.FlatObsBuilder`, so the Trainer treats it exactly like a graph
agent.
"""

from __future__ import annotations

from typing import Callable, Sequence

from . import nn
import jax.numpy as jnp

from ..rl.gaussian import DiagGaussian
from .common import ACTIVATIONS
from .policy import make_std_fn


class MLPGaussianPolicy(nn.Module):
    action_dim: int
    hidden_dims: Sequence[int] = (256, 256)
    activation: str = "tanh"
    contextual_std: bool = True
    init_std: float = 1.0
    minimal_std: float = 1e-5
    max_std: float | None = None  # smooth per-dim std cap (policy.make_std_fn)
    head_init: Callable = nn.initializers.orthogonal(scale=0.01)

    @nn.compact
    def __call__(self, graph, obs: jnp.ndarray) -> DiagGaussian:
        del graph  # flat family
        act = ACTIVATIONS[self.activation]
        h = obs
        for i, d in enumerate(self.hidden_dims):
            h = act(nn.Dense(d, name=f"dense_{i}")(h))
        mean = nn.Dense(self.action_dim, kernel_init=self.head_init, name="mean")(h)
        if self.contextual_std:
            pre = nn.Dense(self.action_dim, kernel_init=self.head_init, name="pre_std")(h)
        else:
            pre = self.param("pre_std", nn.initializers.normal(0.01), (self.action_dim,))
            pre = jnp.broadcast_to(pre, mean.shape)
        std = make_std_fn(self.init_std, self.minimal_std, self.max_std)(pre)
        return DiagGaussian(mean, std)


class MLPCritic(nn.Module):
    """Flat-observation value net (utils_algo.py MLP critic), `(graph, obs)`
    signature for Trainer compatibility."""

    hidden_dims: Sequence[int] = (256, 256)
    activation: str = "tanh"
    head_init: Callable = nn.initializers.orthogonal(scale=0.01)

    @nn.compact
    def __call__(self, graph, obs: jnp.ndarray) -> jnp.ndarray:
        del graph
        act = ACTIVATIONS[self.activation]
        h = obs
        for i, d in enumerate(self.hidden_dims):
            h = act(nn.Dense(d, name=f"dense_{i}")(h))
        return nn.Dense(1, kernel_init=self.head_init, name="final")(h).squeeze(-1)
