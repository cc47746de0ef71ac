"""GCN baseline: edge-attr-weighted message passing over the merged graph.

JAX redesign of `geometry_rl/modules/pyg_models/gcn.py` +
`gnn/mpnn.py::ProcessorLayer(update_edge=False)`: message = x_src * edge_attr
(elementwise, both hidden-dim), scatter-sum, node update x + MLP([x, agg]).
Edge attrs = [edge-type one-hot | relative displacement | distance] — the
HeteroEdgeCategorical / HeteroCartesian / HeteroDistance transform outputs
(pyg_data/transforms.py), computed here inline from positions.
"""

from __future__ import annotations

from typing import Tuple

from . import nn
import jax.numpy as jnp

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from .common import gather_nodes, scatter_sum


class ProcessorLayer(nn.Module):
    """mpnn.py:7-137 with update_edge=False (the GCN configuration)."""

    channels: int
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, src, dst, edge_mask, edge_attr):
        num_nodes = x.shape[1]
        x = x.astype(self.dtype)
        x_j = gather_nodes(x, src)
        agg = scatter_sum(x_j * edge_attr * edge_mask[..., None].astype(self.dtype), dst, num_nodes)
        h = jnp.concatenate([x, agg], axis=-1)
        h = nn.Dense(self.channels, dtype=self.dtype)(h)
        h = nn.relu(h)
        h = nn.Dense(self.channels, dtype=self.dtype)(h)
        h = nn.LayerNorm(dtype=self.dtype)(h)
        return x + h


class GCN(nn.Module):
    hidden_dim: int = 64
    output_dim: int = 6
    num_layers: int = 2
    concat_global: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, graph: HeteroGraph, feats: GraphFeatures) -> Tuple[jnp.ndarray, jnp.ndarray]:
        homo = homogenize(graph)
        x = concat_features(graph, feats)

        # edge attributes: [one-hot type | cartesian | distance] (gcn.py:26,106-110)
        pos_src = gather_nodes(homo.pos, homo.edges.src)
        pos_dst = gather_nodes(homo.pos, homo.edges.dst)
        cart = pos_src - pos_dst
        dist = jnp.linalg.norm(cart, axis=-1, keepdims=True)
        edge_attr = jnp.concatenate([homo.edge_type_onehot, cart, dist], axis=-1)

        x = nn.Dense(self.hidden_dim, dtype=self.dtype, name="node_lin")(x.astype(self.dtype))
        e = nn.Dense(self.hidden_dim, dtype=self.dtype)(edge_attr.astype(self.dtype))
        e = nn.relu(e)
        e = nn.Dense(self.hidden_dim, dtype=self.dtype)(e)
        e = nn.relu(e)
        e = nn.Dense(self.hidden_dim, dtype=self.dtype)(e)
        e = nn.LayerNorm(dtype=self.dtype)(e)

        for i in range(self.num_layers):
            x = ProcessorLayer(self.hidden_dim, dtype=self.dtype, name=f"conv_{i}")(
                x, homo.edges.src, homo.edges.dst, homo.edges.mask, e
            )
        x = x.astype(jnp.float32)

        start, stop = homo.output_slice(graph)
        h = x[:, start:stop]
        if self.concat_global:
            # global max pool over real nodes (gcn.py:120-127)
            neg_inf = jnp.finfo(x.dtype).min
            masked = jnp.where(homo.node_mask[..., None] > 0.5, x, neg_inf)
            g = masked.max(axis=1, keepdims=True)
            h = jnp.concatenate([jnp.broadcast_to(g, h.shape), h], axis=-1)
        out = nn.Dense(self.output_dim, name="mlp")(h)
        return out, h
