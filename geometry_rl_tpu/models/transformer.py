"""Set-transformer baseline over all graph nodes.

JAX redesign of `geometry_rl/modules/pyg_models/transformer_vanilla.py`:
tokens = concatenated flat node features of every node type; a standard
pre-softmax-scaled multi-head encoder; readout at the output node slice,
optionally concatenated with a CLS global token. Padded nodes are masked out
of attention.
"""

from __future__ import annotations

from typing import Tuple

from . import nn
import jax.numpy as jnp

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph


class EncoderLayer(nn.Module):
    """Post-norm torch `TransformerEncoderLayer` semantics (the reference uses
    the default norm_first=False)."""

    hidden_dim: int
    num_heads: int
    dropout: float = 0.1
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, mask=None, deterministic=True):
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads,
            dropout_rate=self.dropout,
            deterministic=deterministic,
            dtype=self.dtype,
        )(x, x, mask=mask)
        x = nn.LayerNorm(dtype=self.dtype)(x + nn.Dropout(self.dropout, deterministic=deterministic)(attn))
        h = nn.Dense(self.hidden_dim, dtype=self.dtype)(x)
        h = nn.relu(h)
        h = nn.Dropout(self.dropout, deterministic=deterministic)(h)
        h = nn.Dense(self.hidden_dim, dtype=self.dtype)(h)
        return nn.LayerNorm(dtype=self.dtype)(x + nn.Dropout(self.dropout, deterministic=deterministic)(h))


class TransformerVanilla(nn.Module):
    hidden_dim: int = 64
    output_dim: int = 6
    num_layers: int = 2
    num_heads: int = 2
    dropout: float = 0.1
    concat_global: bool = False
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self, graph: HeteroGraph, feats: GraphFeatures, deterministic: bool = True
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        homo = homogenize(graph)
        x = concat_features(graph, feats)  # [B,Ntot,F]
        B = x.shape[0]

        x = nn.Dense(self.hidden_dim, dtype=self.dtype, name="embedding")(x.astype(self.dtype))
        node_mask = homo.node_mask  # [B,Ntot]

        if self.concat_global:
            cls = self.param("cls_token", nn.initializers.normal(1.0), (1, 1, self.hidden_dim))
            x = jnp.concatenate([jnp.broadcast_to(cls, (B, 1, self.hidden_dim)), x], axis=1)
            node_mask = jnp.concatenate([jnp.ones((B, 1), node_mask.dtype), node_mask], axis=1)

        attn_mask = node_mask[:, None, None, :] > 0.5  # [B,1,1,N] key mask
        for i in range(self.num_layers):
            x = EncoderLayer(self.hidden_dim, self.num_heads, self.dropout, dtype=self.dtype, name=f"layer_{i}")(
                x, mask=attn_mask, deterministic=deterministic
            )

        start, stop = homo.output_slice(graph)
        if self.concat_global:
            cls_out = x[:, 0]
            h = x[:, start + 1 : stop + 1]
            g = jnp.broadcast_to(cls_out[:, None, :], h.shape)
            h = jnp.concatenate([g, h], axis=-1)
        else:
            h = x[:, start:stop]

        h = h.astype(jnp.float32)
        out = nn.Dense(self.output_dim, name="fc_out")(h)  # [B,G,output_dim]
        return out, h
