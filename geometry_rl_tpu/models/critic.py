"""Value networks.

JAX redesign of
`geometry_rl/algorithms/trust_region_projections/models/value/gnn_vf_net.py`
(graph critic: backbone latent -> Linear -> scalar) and the MLP fallback in
`examples/torchrl/builders/utils_algo_graph.py:187-198`.
"""

from __future__ import annotations

from typing import Callable, Sequence

from . import nn
import jax.numpy as jnp

from ..graphs.types import GraphFeatures, HeteroGraph
from .common import ACTIVATIONS


class GraphValueNet(nn.Module):
    """backbone (e.g. DeepSets on the full graph) -> Linear(latent, 1)."""

    backbone: nn.Module
    head_init: Callable = nn.initializers.orthogonal(scale=0.01)

    @nn.compact
    def __call__(self, graph: HeteroGraph, feats: GraphFeatures, **backbone_kwargs) -> jnp.ndarray:
        h = self.backbone(graph, feats, **backbone_kwargs)
        if isinstance(h, tuple):  # (out, latent) backbones: pool the latent
            h = h[1].mean(axis=1)
        value = nn.Dense(1, kernel_init=self.head_init, name="final")(h)
        return value.squeeze(-1)  # [B]


class MLPValueNet(nn.Module):
    """Flat-observation MLP critic (utils_algo_graph.py:187-193)."""

    hidden_dims: Sequence[int] = (64, 64)
    activation: str = "elu"
    head_init: Callable = nn.initializers.orthogonal(scale=0.01)

    @nn.compact
    def __call__(self, obs: jnp.ndarray) -> jnp.ndarray:
        act = ACTIVATIONS[self.activation]
        h = obs
        for i, d in enumerate(self.hidden_dims):
            h = act(nn.Dense(d, name=f"dense_{i}")(h))
        return nn.Dense(1, kernel_init=self.head_init, name="final")(h).squeeze(-1)
