"""PONITA building blocks — position-orientation space equivariance.

JAX redesign of `geometry_rl/modules/pyg_models/ponita/{ponita,conv}.py`:
node signals live on a fixed S2 orientation grid [O, 3]; spatial message
passing is gather -> elementwise kernel -> batched scatter-add, and the fiber
(spherical) convolution is a dense einsum over orientations — a matmul.
All tensors are padded per-env dense arrays [B, N, O, C] (no PyG batching).

Equivariance: features depend on geometry only through the pairwise invariants
(displacement along / orthogonal to each orientation, ori·ori), so rotating
positions AND the grid rotates vector outputs exactly (tested in
tests/test_models.py, generalizing the reference's ponita.py:372-449 demo).
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import nn
import jax.numpy as jnp

from .common import gather_nodes, scatter_sum


def scalar_to_sphere(scalar: jnp.ndarray, ori_grid: jnp.ndarray) -> jnp.ndarray:
    """[..., S] -> [..., O, S]: broadcast scalar channels over orientations
    (ponita/utils/to_from_sphere.py)."""
    num_ori = ori_grid.shape[0]
    return jnp.repeat(scalar[..., None, :], num_ori, axis=-2)


def vec_to_sphere(vec: jnp.ndarray, ori_grid: jnp.ndarray) -> jnp.ndarray:
    """[..., V, D] -> [..., O, V]: project each vector channel onto each
    orientation (inner product with the grid directions)."""
    return jnp.einsum("...vd,od->...ov", vec, ori_grid)


def sphere_to_scalar(x: jnp.ndarray) -> jnp.ndarray:
    """[..., O, S] -> [..., S]: mean over orientations."""
    return x.mean(axis=-2)


def sphere_to_vec(x: jnp.ndarray, ori_grid: jnp.ndarray) -> jnp.ndarray:
    """[..., O, V] -> [..., V, D]: signal-weighted sum of grid directions."""
    return jnp.einsum("...ov,od->...vd", x, ori_grid) / ori_grid.shape[0]


def polynomial_features(x: jnp.ndarray, degree: int) -> jnp.ndarray:
    """All monomials of x up to `degree`+1 via iterated outer products
    (ponita.py:233-244). Input [..., d] -> [..., sum_{i=1..degree+1} d^i]."""
    feats = [x]
    for _ in range(degree):
        outer = jnp.einsum("...i,...j->...ij", feats[-1], x)
        feats.append(outer.reshape(outer.shape[:-2] + (-1,)))
    return jnp.concatenate(feats, axis=-1)


def compute_invariants(
    ori_grid: jnp.ndarray, pos_src: jnp.ndarray, pos_dst: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pairwise position-orientation invariants (hepi.py:109-123).

    pos_src/pos_dst: [..., E, 3] endpoint positions per edge.
    Returns (spatial [..., E, O, 2], orientation [O, O, 1]).
    """
    rel_pos = (pos_src - pos_dst)[..., None, :]  # [..., E, 1, 3]
    ori_a = ori_grid[None, :, :]  # [1, O, 3]
    inv1 = jnp.sum(rel_pos * ori_a, axis=-1, keepdims=True)  # along-ori displacement
    inv2 = jnp.linalg.norm(rel_pos - inv1 * ori_a, axis=-1, keepdims=True)  # orthogonal
    spatial = jnp.concatenate([inv1, inv2], axis=-1)
    ori_inv = jnp.sum(ori_grid[None, :, :] * ori_grid[:, None, :], axis=-1, keepdims=True)
    return spatial, ori_inv


class PolynomialBasis(nn.Module):
    """basis_fn / fiber_basis_fn: PolynomialFeatures -> Dense -> GELU -> Dense
    -> GELU (hepi.py:76-89)."""

    hidden_dim: int
    basis_dim: int
    degree: int = 2
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = polynomial_features(x.astype(self.dtype), self.degree)
        x = nn.gelu(nn.Dense(self.hidden_dim, dtype=self.dtype)(x))
        x = nn.gelu(nn.Dense(self.basis_dim, dtype=self.dtype)(x))
        return x


class FiberBundleConv(nn.Module):
    """Separable group conv on the position-orientation fiber bundle
    (ponita/conv.py:7-157), depthwise variant (groups == channels — the only
    configuration the reference instantiates, hepi.yaml `groups: *latent_dim`).

    forward(x_src [B,Ns,O,C], x_dst [B,Nd,O,C], edges, kernel_basis
    [B,E,O,A], fiber_basis [O,O,A]) -> updated_dst [B,Nd,O,C]:

      1. spatial conv: m_e = kernel(basis_e) * x_src[src_e]; x1 = scatter-add
      2. fiber conv:   x2 = einsum(x1, fiber_kernel) / O   (dense matmul)
      3. ConvNeXt update: dst + MLP(LN(x2 + bias))
    """

    channels: int
    widening_factor: int = 4
    use_bias: bool = True
    # depthwise=True is the only configuration the reference instantiates
    # (groups == channels); depthwise=False is conv.py's groups=1 variant
    # (full in->out channel mixing in the fiber conv)
    depthwise: bool = True
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x_src, x_dst, src, dst, edge_mask, kernel_basis, fiber_basis):
        num_dst = x_dst.shape[1]
        x_src = x_src.astype(self.dtype)
        x_dst = x_dst.astype(self.dtype)

        kernel = nn.Dense(self.channels, use_bias=False, dtype=self.dtype, name="kernel")(kernel_basis)

        # gather -> kernel multiply -> scatter, all in FLATTENED [B,E,O*C]
        # space: the one-hot matmul lowering wants an f-minor layout, and the
        # elementwise multiply runs in that same layout, so XLA inserts no
        # relayout copies between them.
        B, E = src.shape
        O, C = x_src.shape[-2], x_src.shape[-1]
        x_j = gather_nodes(x_src.reshape(B, -1, O * C), src)  # [B,E,O*C]
        messages = kernel.reshape(B, E, O * C) * x_j * edge_mask[..., None].astype(self.dtype)
        x_1 = scatter_sum(messages, dst, num_dst).reshape(B, num_dst, O, C)

        # fiber (spherical) conv — dense contraction over orientations
        if self.depthwise:
            fiber_kernel = nn.Dense(self.channels, use_bias=False, dtype=self.dtype, name="fiber_kernel")(fiber_basis)
            x_2 = jnp.einsum("bnoc,opc->bnpc", x_1, fiber_kernel, preferred_element_type=self.dtype) / fiber_kernel.shape[-2]
        else:
            in_c = x_1.shape[-1]
            fk = nn.Dense(self.channels * in_c, use_bias=False, dtype=self.dtype, name="fiber_kernel")(fiber_basis)
            fk = fk.reshape(fk.shape[:-1] + (self.channels, in_c))  # [O,P,out,in]
            x_2 = jnp.einsum("bnoc,opdc->bnpd", x_1, fk, preferred_element_type=self.dtype) / fk.shape[0]

        # expose pre-activation stds so a one-shot calibration pass can rescale
        # kernel weights like the reference's first-train-step callibrate()
        # (conv.py:151-157)
        self.sow("calibration", "std_in", x_dst.std())
        self.sow("calibration", "std_1", x_1.std())
        self.sow("calibration", "std_2", x_2.std())

        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.channels,))
            x_2 = x_2 + bias.astype(self.dtype)

        h = nn.LayerNorm(dtype=self.dtype)(x_2)
        h = nn.Dense(self.channels * self.widening_factor, dtype=self.dtype)(h)
        h = nn.gelu(h)
        h = nn.Dense(self.channels, dtype=self.dtype)(h)
        return x_dst + h


class SeparableFiberBundleConvNext(nn.Module):
    """Homogeneous-graph ConvNeXt block (ponita.py:195-230) used by PonitaGCN:
    conv -> LayerNorm -> widening MLP -> layer-scale -> residual."""

    channels: int
    widening_factor: int = 4
    layer_scale_init: Optional[float] = 1e-6
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, src, dst, edge_mask, kernel_basis, fiber_basis):
        num_nodes = x.shape[1]
        x = x.astype(self.dtype)

        kernel = nn.Dense(self.channels, use_bias=False, dtype=self.dtype, name="kernel")(kernel_basis)
        fiber_kernel = nn.Dense(self.channels, use_bias=False, dtype=self.dtype, name="fiber_kernel")(fiber_basis)

        # flattened-message form — see FiberBundleConv above for the rationale
        B, E = src.shape
        O, C = x.shape[-2], x.shape[-1]
        x_j = gather_nodes(x.reshape(B, -1, O * C), src)  # [B,E,O*C]
        messages = kernel.reshape(B, E, O * C) * x_j * edge_mask[..., None].astype(self.dtype)
        x_1 = scatter_sum(messages, dst, num_nodes).reshape(B, num_nodes, O, C)
        x_2 = jnp.einsum("bnoc,opc->bnpc", x_1, fiber_kernel, preferred_element_type=self.dtype) / fiber_kernel.shape[-2]

        self.sow("calibration", "std_in", x.std())
        self.sow("calibration", "std_1", x_1.std())
        self.sow("calibration", "std_2", x_2.std())

        bias = self.param("bias", nn.initializers.zeros, (self.channels,))
        h = x_2 + bias.astype(self.dtype)

        h = nn.LayerNorm(dtype=self.dtype)(h)
        h = nn.Dense(self.channels * self.widening_factor, dtype=self.dtype)(h)
        h = nn.gelu(h)
        h = nn.Dense(self.channels, dtype=self.dtype)(h)
        if self.layer_scale_init is not None:
            scale = self.param(
                "layer_scale",
                nn.initializers.constant(self.layer_scale_init),
                (self.channels,),
            )
            h = scale.astype(self.dtype) * h
        return x + h
