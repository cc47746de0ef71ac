"""MeshGraphNet-style encode-process-decode GNN.

JAX redesign of `geometry_rl/modules/pyg_models/gnn/{base_gnn,mpnn}.py`:
node/edge MLP encoders, N ProcessorLayers with residual EDGE updates
(mpnn.py update_edge=True: e' = e + MLP([x_dst, x_src, e]); node update
x' = x + MLP([x, sum_in e'])), and a node decoder read out at the output
node slice. Operates on the homogenized graph like the GCN baseline.
"""

from __future__ import annotations

from typing import Tuple

from . import nn
import jax.numpy as jnp

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from .common import gather_nodes, scatter_sum


def _mlp(widths, dtype, layer_norm=True):
    layers = []
    for i, w in enumerate(widths):
        layers.append(nn.Dense(w, dtype=dtype))
        if i < len(widths) - 1:
            layers.append(nn.relu)
    if layer_norm:
        layers.append(nn.LayerNorm(dtype=dtype))
    return nn.Sequential(layers)


class EdgeProcessorLayer(nn.Module):
    """mpnn.py ProcessorLayer with update_edge=True."""

    channels: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, e, src, dst, edge_mask):
        num_nodes = x.shape[1]
        x_i = gather_nodes(x, dst)
        x_j = gather_nodes(x, src)
        e_new = e + _mlp([self.channels, self.channels], self.dtype)(
            jnp.concatenate([x_i, x_j, e], axis=-1)
        )
        agg = scatter_sum(e_new * edge_mask[..., None].astype(e_new.dtype), dst, num_nodes)
        x_new = x + _mlp([self.channels, self.channels], self.dtype)(
            jnp.concatenate([x, agg], axis=-1)
        )
        return x_new, e_new


class MeshGraphNet(nn.Module):
    """base_gnn.py BaseGNN equivalent: encoders -> N processors -> decoder."""

    hidden_dim: int = 64
    output_dim: int = 64
    num_layers: int = 2
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, graph: HeteroGraph, feats: GraphFeatures) -> Tuple[jnp.ndarray, jnp.ndarray]:
        homo = homogenize(graph)
        x = concat_features(graph, feats).astype(self.dtype)

        pos_src = gather_nodes(homo.pos, homo.edges.src)
        pos_dst = gather_nodes(homo.pos, homo.edges.dst)
        cart = pos_src - pos_dst
        dist = jnp.linalg.norm(cart, axis=-1, keepdims=True)
        edge_in = jnp.concatenate([homo.edge_type_onehot, cart, dist], axis=-1).astype(self.dtype)

        x = _mlp([self.hidden_dim, self.hidden_dim], self.dtype)(x)
        e = _mlp([self.hidden_dim, self.hidden_dim], self.dtype)(edge_in)

        for i in range(self.num_layers):
            x, e = EdgeProcessorLayer(self.hidden_dim, dtype=self.dtype, name=f"processor_{i}")(
                x, e, homo.edges.src, homo.edges.dst, homo.edges.mask
            )

        x = x.astype(jnp.float32)
        start, stop = homo.output_slice(graph)
        h = x[:, start:stop]
        out = nn.Dense(self.output_dim, name="decoder")(h)
        return out, h
