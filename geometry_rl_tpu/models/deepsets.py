"""DeepSets — the critic backbone in every reference config (deepsets.yaml).

JAX redesign of `geometry_rl/modules/pyg_models/deepsets.py`: inner MLP per
node (all node types concatenated, padded nodes masked out of the sum), sum
pooling, outer MLP. Returns a per-graph latent [B, output_dim]; the value head
(Linear -> 1) lives in models/critic.py like GNNVFNet.final.
"""

from __future__ import annotations

from . import nn
import jax.numpy as jnp

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph


class DeepSets(nn.Module):
    hidden_dim: int = 64
    output_dim: int = 64
    layer_norm: bool = True  # deepsets.yaml norm: [layer_norm, layer_norm]
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, graph: HeteroGraph, feats: GraphFeatures) -> jnp.ndarray:
        homo = homogenize(graph)
        x = concat_features(graph, feats)  # [B,Ntot,F]

        # inner MLP (PyG MLP: hidden layers get norm+relu, output raw)
        x = nn.Dense(self.hidden_dim, dtype=self.dtype)(x.astype(self.dtype))
        if self.layer_norm:
            x = nn.LayerNorm(dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Dense(self.hidden_dim, dtype=self.dtype)(x)

        x = (x * homo.node_mask[..., None].astype(self.dtype)).sum(axis=1)  # masked sum pool

        x = nn.Dense(self.hidden_dim, dtype=self.dtype)(x)
        if self.layer_norm:
            x = nn.LayerNorm(dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Dense(self.output_dim, dtype=self.dtype)(x)
        return x.astype(jnp.float32)
