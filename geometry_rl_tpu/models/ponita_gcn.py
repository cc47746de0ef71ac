"""PonitaGCN ("EMPN") — homogeneous PONITA over the merged graph.

JAX redesign of `geometry_rl/modules/pyg_models/ponita_gcn.py`: the hetero
graph is homogenized (node types concatenated, edges offset) and a stack of
SeparableFiberBundleConvNext layers runs over all nodes; readout happens at
the output node slice. This is the paper's EMPN baseline
(`*_empn_trpl_cfg.yaml` overrides model -> ponita_gcn).
"""

from __future__ import annotations

from typing import Tuple

from . import nn
import jax.numpy as jnp

from ..graphs.homogenize import homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from ..utils.math import fibonacci_lattice
from .common import gather_nodes
from .ponita import (
    PolynomialBasis,
    SeparableFiberBundleConvNext,
    compute_invariants,
    scalar_to_sphere,
    vec_to_sphere,
)


class PonitaGCN(nn.Module):
    latent_dim: int = 64
    hidden_dim: int = 64
    output_dim: int = 1
    output_dim_vec: int = 1
    num_layers: int = 2
    num_ori: int = 16
    degree: int = 2
    widening_factor: int = 4
    only_upper_hemisphere: bool = True
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(
        self, graph: HeteroGraph, feats: GraphFeatures, ori_grid=None
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        if ori_grid is None:
            ori_grid = fibonacci_lattice(self.num_ori, upper_hemisphere=self.only_upper_hemisphere)
        homo = homogenize(graph)

        # merged sphere-lifted inputs (ponita_gcn.py:94-127)
        xs = []
        for nt in graph.nodes.keys():
            scalar = scalar_to_sphere(feats.scalars[nt], ori_grid)
            vector = vec_to_sphere(feats.vectors[nt], ori_grid)
            xs.append(jnp.concatenate([scalar, vector], axis=-1))
        x = jnp.concatenate(xs, axis=1)  # [B,Ntot,O,S+V]

        x = nn.Dense(self.hidden_dim, use_bias=False, dtype=self.dtype, name="x_embedder")(x.astype(self.dtype))

        pos_src = gather_nodes(homo.pos, homo.edges.src)
        pos_dst = gather_nodes(homo.pos, homo.edges.dst)
        spatial_inv, ori_inv = compute_invariants(ori_grid, pos_src, pos_dst)
        kernel_basis = PolynomialBasis(self.hidden_dim, self.hidden_dim, self.degree, dtype=self.dtype, name="basis_fn")(spatial_inv)
        fiber_basis = PolynomialBasis(self.hidden_dim, self.hidden_dim, self.degree, dtype=self.dtype, name="fiber_basis_fn")(ori_inv)

        for i in range(self.num_layers):
            x = SeparableFiberBundleConvNext(
                self.hidden_dim,
                widening_factor=self.widening_factor,
                layer_scale_init=None,  # ponita_gcn.py:49 layer_scale=None
                dtype=self.dtype,
                name=f"interaction_{i}",
            )(x, homo.edges.src, homo.edges.dst, homo.edges.mask, kernel_basis, fiber_basis)

        output = nn.Dense(self.output_dim + self.output_dim_vec, dtype=self.dtype, name="readout")(x).astype(jnp.float32)
        x = x.astype(jnp.float32)
        out_scalar = output[..., : self.output_dim].mean(axis=-2)  # [B,Ntot,out_s]
        out_vec = jnp.einsum("bnov,od->bnvd", output[..., self.output_dim :], ori_grid) / self.num_ori

        start, stop = homo.output_slice(graph)
        hidden = x.mean(axis=-2)[:, start:stop]  # [B,G,C]
        out = out_vec[:, start:stop] * out_scalar[:, start:stop, :, None]  # [B,G,out_v,3]
        return out, hidden
