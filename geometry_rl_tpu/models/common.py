"""Shared NN building blocks: MLPs, initializers, segment ops.

Replaces the reference's `utils/network_utils.py` (MLP builder + init) with
equivalents on the in-repo module layer (models/nn.py), and torch_scatter
with XLA segment ops batched over envs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from . import nn
import jax
import jax.numpy as jnp


def orthogonal_init(gain: float = 1.0):
    return nn.initializers.orthogonal(scale=gain)


ACTIVATIONS = {
    "tanh": nn.tanh,
    "relu": nn.relu,
    "elu": nn.elu,
    "gelu": nn.gelu,
    "silu": nn.silu,
}


class MLP(nn.Module):
    """Plain MLP. `features` are the hidden+output sizes; activation between
    layers, optional LayerNorm after hidden layers (PyG MLP `norm` semantics:
    norm applies to hidden layers, not the output)."""

    features: Sequence[int]
    activation: Callable = nn.gelu
    layer_norm: bool = False
    final_activation: bool = False
    kernel_init: Callable = nn.initializers.lecun_normal()
    bias_init: Callable = nn.initializers.zeros

    @nn.compact
    def __call__(self, x):
        n = len(self.features)
        for i, f in enumerate(self.features):
            x = nn.Dense(f, kernel_init=self.kernel_init, bias_init=self.bias_init)(x)
            is_last = i == n - 1
            if not is_last or self.final_activation:
                if self.layer_norm:
                    x = nn.LayerNorm()(x)
                x = self.activation(x)
        return x


# Below this node count, gathers/scatters are lowered to one-hot MATMULS
# (an [E, N] x [N, F] contraction); above it, to vmapped take/segment_sum.
# Which is faster on the GPU at each node count is not measured yet.
MATMUL_GATHER_MAX_NODES = 512


def _one_hot(idx: jnp.ndarray, num_classes: int, dtype) -> jnp.ndarray:
    return jax.nn.one_hot(idx, num_classes, dtype=dtype)


def gather_nodes(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Batched node gather: x [B, N, ...], idx [B, E] int -> [B, E, ...]."""
    N = x.shape[1]
    if N <= MATMUL_GATHER_MAX_NODES and x.ndim >= 3:
        onehot = _one_hot(idx, N, x.dtype)  # [B, E, N]
        flat = x.reshape(x.shape[0], N, -1)
        out = jnp.einsum("ben,bnf->bef", onehot, flat, preferred_element_type=x.dtype)
        return out.reshape(idx.shape + x.shape[2:])
    return jax.vmap(lambda xi, ii: jnp.take(xi, ii, axis=0))(x, idx)


def scatter_sum(messages: jnp.ndarray, dst: jnp.ndarray, num_nodes: int) -> jnp.ndarray:
    """Batched scatter-add: messages [B, E, ...], dst [B, E] -> [B, N, ...].

    The torch_scatter.scatter(reduce='sum') equivalent (conv.py:141-148).
    Small node counts use the one-hot-matmul lowering (see
    MATMUL_GATHER_MAX_NODES); larger ones fall back to vmapped segment_sum.
    """
    if num_nodes <= MATMUL_GATHER_MAX_NODES and messages.ndim >= 3:
        onehot = _one_hot(dst, num_nodes, messages.dtype)  # [B, E, N]
        flat = messages.reshape(messages.shape[0], messages.shape[1], -1)
        out = jnp.einsum("ben,bef->bnf", onehot, flat, preferred_element_type=messages.dtype)
        return out.reshape((messages.shape[0], num_nodes) + messages.shape[2:])
    return jax.vmap(lambda m, d: jax.ops.segment_sum(m, d, num_segments=num_nodes))(messages, dst)


def scatter_mean(messages: jnp.ndarray, dst: jnp.ndarray, num_nodes: int, mask: Optional[jnp.ndarray] = None):
    if mask is not None:
        messages = messages * mask[(...,) + (None,) * (messages.ndim - mask.ndim)]
        weights = mask
    else:
        weights = jnp.ones(dst.shape, messages.dtype)
    total = scatter_sum(messages, dst, num_nodes)
    counts = scatter_sum(weights, dst, num_nodes)  # [B, N]
    counts = jnp.maximum(counts, 1.0).reshape(counts.shape + (1,) * (total.ndim - 2))
    return total / counts
