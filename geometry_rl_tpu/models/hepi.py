"""HEPi — Heterogeneous E(3)-equivariant PONITA policy network.

JAX redesign of `geometry_rl/modules/pyg_models/hepi.py`: node signals are
lifted onto a fixed S2 orientation grid, message passing runs per edge LEVEL
with a binary per-round schedule (`message_codes`), and the decoder produces
equivariant vector outputs as orientation-weighted sums.

Interface: `__call__(graph: HeteroGraph, feats: GraphFeatures) ->
(out [B, G, output_dim_vec, 3], latent [B, G, latent_dim])` where G is the
number of output nodes (grippers). The policy heads (mean reshape + std) live
in `models/policy.py`, mirroring `gnn_gaussian_policy_diag.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from . import nn
import jax.numpy as jnp

from ..graphs.types import GraphFeatures, HeteroGraph
from ..utils.math import fibonacci_lattice
from .common import gather_nodes
from .ponita import (
    FiberBundleConv,
    PolynomialBasis,
    compute_invariants,
    scalar_to_sphere,
    vec_to_sphere,
)


class HEPi(nn.Module):
    """Config mirrors configs/algorithm/pyg_agent/model/hepi.yaml."""

    latent_dim: int = 64
    hidden_dim: int = 64
    output_dim: int = 1  # scalar output channels
    output_dim_vec: int = 1  # vector output channels
    num_ori: int = 16
    degree: int = 2
    num_messages: int = 2
    # message schedule: edge_levels[l] is active in round k iff
    # message_codes[l][k] == 1 (hepi.yaml codes [1,0]/[0,1]/[0,1] for
    # internal/agent/task)
    edge_levels: Sequence[str] = ("internal", "agent", "task")
    message_codes: Sequence[Sequence[int]] = ((1, 0), (0, 1), (0, 1))
    only_upper_hemisphere: bool = True
    basis_dim: Optional[int] = None
    widening_factor: int = 4
    concat_global: bool = False
    dtype: jnp.dtype = jnp.float32  # activation/compute dtype (bf16 for mixed precision)

    @nn.compact
    def __call__(
        self, graph: HeteroGraph, feats: GraphFeatures, ori_grid: Optional[jnp.ndarray] = None
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        # ori_grid override exists so equivariance can be verified EXACTLY:
        # rotating inputs AND the grid must rotate vector outputs.
        if ori_grid is None:
            ori_grid = fibonacci_lattice(self.num_ori, upper_hemisphere=self.only_upper_hemisphere)
        basis_dim = self.basis_dim or self.hidden_dim

        # shared basis networks (hepi.py:76-89)
        basis_fn = PolynomialBasis(self.hidden_dim, basis_dim, self.degree, dtype=self.dtype, name="basis_fn")
        fiber_basis_fn = PolynomialBasis(self.hidden_dim, basis_dim, self.degree, dtype=self.dtype, name="fiber_basis_fn")

        # node encoder shared across node types (hepi.py:91,136-143)
        node_encoder = nn.Dense(self.latent_dim, use_bias=False, dtype=self.dtype, name="node_encoder")
        latent: Dict[str, jnp.ndarray] = {}
        for nt in graph.node_types:
            scalar = scalar_to_sphere(feats.scalars[nt], ori_grid)  # [B,N,O,S]
            vector = vec_to_sphere(feats.vectors[nt], ori_grid)  # [B,N,O,V]
            x = jnp.concatenate([scalar, vector], axis=-1)
            latent[nt] = node_encoder(x.astype(self.dtype))

        # pairwise invariants + kernel bases per edge type (hepi.py:145-157).
        # NOTE: invariants use RAW positions (graph pos), not normalized —
        # matching `_update_placeholders` (rigid_tasks_data.py:248) where
        # HeteroCartesian runs on `pos`.
        kernel_basis: Dict = {}
        fiber_basis = None
        for ek, es in graph.edges.items():
            src, _, dst = ek
            pos_src = gather_nodes(graph.nodes[src].pos, es.src)
            pos_dst = gather_nodes(graph.nodes[dst].pos, es.dst)
            spatial_inv, ori_inv = compute_invariants(ori_grid, pos_src, pos_dst)
            kernel_basis[ek] = basis_fn(spatial_inv)
            if fiber_basis is None:
                fiber_basis = fiber_basis_fn(ori_inv)  # [O,O,basis] — edge-type independent

        # message rounds: one FiberBundleConv per (round, level), shared across
        # edge types within a level (utils_algo_graph.py:34-47 + hepi.py:93-104)
        for k in range(self.num_messages):
            convs: Dict[str, FiberBundleConv] = {}
            for li, level in enumerate(self.edge_levels):
                if self.message_codes[li][k] == 1:
                    convs[level] = FiberBundleConv(
                        self.latent_dim,
                        widening_factor=self.widening_factor,
                        dtype=self.dtype,
                        name=f"processor_{k}_{level}",
                    )
            # HeteroFiberConv grouping: each active edge type produces an
            # updated dst; multiple edge types into the same dst SUM
            # (hetero_fiber_conv.py:58-64, aggr="sum")
            out_dst: Dict[str, list] = {}
            for ek, es in graph.edges.items():
                src, level, dst = ek
                conv = convs.get(level)
                if conv is None:
                    continue
                updated = conv(latent[src], latent[dst], es.src, es.dst, es.mask, kernel_basis[ek], fiber_basis)
                out_dst.setdefault(dst, []).append(updated)
            for dst, vals in out_dst.items():
                latent[dst] = sum(vals) if len(vals) > 1 else vals[0]

        h = latent[graph.output_node_type]  # [B,G,O,C]

        if self.concat_global:
            # global mean over every node of every type (hepi.py:175-178)
            all_nodes = jnp.concatenate([latent[nt] for nt in graph.node_types], axis=1)
            g = all_nodes.mean(axis=1, keepdims=True)
            h = jnp.concatenate([h, jnp.broadcast_to(g, h.shape[:2] + g.shape[2:])], axis=-1)

        output = nn.Dense(self.output_dim + self.output_dim_vec, dtype=self.dtype, name="decoder")(h)
        # decode in f32: action means / std inputs need full precision
        output = output.astype(jnp.float32)
        out_scalar = output[..., : self.output_dim].mean(axis=-2)  # [B,G,out_s]
        out_vec_sph = output[..., self.output_dim :]  # [B,G,O,out_v]
        out_vec = jnp.einsum("bgov,od->bgvd", out_vec_sph, ori_grid) / self.num_ori  # [B,G,out_v,3]
        out = out_vec * out_scalar[..., None]  # (hepi.py:186-187)

        latent_mean = h.astype(jnp.float32).mean(axis=-2)  # [B,G,latent]
        return out, latent_mean
