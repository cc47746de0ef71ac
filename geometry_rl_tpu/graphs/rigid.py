"""Rigid-task graph builder: observation groups -> HeteroGraph + features.

JAX redesign of `geometry_rl/modules/pyg_data/rigid_tasks_data.py`. The
reference rebuilds per-env PyG graphs in a Python loop whenever the batch size
changes (placeholder cache, `_construct_placeholders:257-343`); here topology
is STATIC per environment: the kNN graph of a rigid body's mesh points is
invariant under rigid transforms, so internal edges are precomputed per shape
at construction (numpy, once) — no runtime kNN at all.

Node types (NodeType enum, target excluded: rigid_tasks_data.py:91):
  object_geometry (padded mesh points), grippers.
Edge types (rigid_tasks_data.py:32-47):
  (object_geometry, internal, object_geometry) — kNN(k=3) over mesh points,
  (grippers, agent, grippers)                  — fully connected (G > 1),
  (object_geometry, task, grippers)            — fully connected.

Features (construct_input_vector, concat_input_vector=False):
  scalars = node-type one-hot (3 classes incl. the excluded target class,
  matching input_dim_node = len(NodeType) + 4);
  vectors = [norm_pos, corresponding_pos, velocity, angular_velocity] with
  corresponding_pos = norm_pos - target (dist_as_pos) or target, and per-point
  broadcast root velocities for the object.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.base import ObsSpec
from .types import EdgeSet, GraphFeatures, HeteroGraph, NodeSet

NODE_TYPES = ("object_geometry", "grippers", "target_geometry")  # one-hot order


def knn_edges_np(points: np.ndarray, num_valid: int, k: int) -> np.ndarray:
    """Directed kNN edges (j -> i for j among i's k nearest), like PyG
    knn_graph. points: [P, 3]; returns [num_valid * k, 2] (src, dst)."""
    pts = points[:num_valid]
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    nbrs = np.argsort(d, axis=-1)[:, :k]  # [n, k]
    dst = np.repeat(np.arange(num_valid), k)
    src = nbrs.reshape(-1)
    return np.stack([src, dst], axis=-1)


def apply_training_noise(
    vectors: Dict[str, jnp.ndarray], noise_key: jnp.ndarray, std: float
) -> Dict[str, jnp.ndarray]:
    """Gaussian data-augmentation noise on the per-node vector features
    (pyg_data/utils.py noise_like + base_data training_noise): applied only on
    training forwards, sampled fresh per update step."""
    keys = jax.random.split(noise_key, len(vectors))
    return {
        nt: v + std * jax.random.normal(k, v.shape, v.dtype)
        for (nt, v), k in zip(vectors.items(), keys)
    }


def split_group(obs: jnp.ndarray, spec: ObsSpec, group: str) -> Dict[str, jnp.ndarray]:
    """Split a flat group tensor into named terms (BaseData._preprocess_input)."""
    out = {}
    start = 0
    for name, dim in zip(spec.names[group], spec.dims[group]):
        out[name] = obs[..., start : start + dim]
        start += dim
    return out


@dataclasses.dataclass(frozen=True)
class RigidGraphBuilder:
    """Static per-env graph topology + feature construction.

    Build once per env via `RigidGraphBuilder.from_env(env, ...)`; `build` is a
    pure jit-safe function over observation dicts. Supports sample-level
    indexing (`env_ids`) so shuffled minibatches gather the right topology.
    """

    obs_spec: ObsSpec
    num_grippers: int
    num_points: int  # P_max
    dist_as_pos: bool
    angular_velocity: bool
    output_mask_key: str
    # per-env static topology [B_env, ...]
    internal_src: jnp.ndarray
    internal_dst: jnp.ndarray
    internal_mask: jnp.ndarray
    point_mask: jnp.ndarray  # [B_env, P]
    # training noise on positions/velocities (base_data training_noise /
    # pyg_data/utils.noise_like; configs ship with False)
    training_noise: bool = False
    training_noise_std: float = 1e-2

    @staticmethod
    def from_env(
        env,
        dist_as_pos: bool = True,
        angular_velocity: bool = True,
        knn_k: int = 3,
        training_noise: bool = False,
        training_noise_std: float = 1e-2,
    ):
        """Precompute per-shape kNN topology (native C++ builder when
        available — geometry_rl_tpu.native.knn_graph_batch), then gather per
        env."""
        from .. import native

        pts = np.asarray(env.shape_set.points)  # [S, P, 3]
        n_pts = np.asarray(env.shape_set.num_points)
        P = pts.shape[1]
        src, dst, mask = native.knn_graph_batch(pts, n_pts, knn_k)
        ids = np.asarray(env.shape_ids)
        has_obj_ang = "object_geometry_angular" in env.obs_spec.names["velocity_vectors"]
        return RigidGraphBuilder(
            obs_spec=env.obs_spec,
            num_grippers=env.cfg.num_grippers,
            num_points=P,
            dist_as_pos=dist_as_pos,
            angular_velocity=angular_velocity and has_obj_ang,
            output_mask_key="grippers",
            training_noise=training_noise,
            training_noise_std=training_noise_std,
            internal_src=jnp.asarray(src[ids]),
            internal_dst=jnp.asarray(dst[ids]),
            internal_mask=jnp.asarray(mask[ids]),
            point_mask=env.obj_point_mask,
        )

    # ------------------------------------------------------------------ build

    def build(
        self,
        tobs: Dict[str, jnp.ndarray],
        env_ids: Optional[jnp.ndarray] = None,
        noise_key: Optional[jnp.ndarray] = None,
    ) -> Tuple[HeteroGraph, GraphFeatures]:
        """tobs: transformed observation dict (obs_pipeline output) with raw
        `position_vectors` plus `norm_position_vectors` / `norm_velocity_vectors`,
        each [N, D_group]; env_ids [N] maps each sample to its environment's
        static topology (default: arange — collection layout)."""
        spec = self.obs_spec
        B = tobs["position_vectors"].shape[0]
        G, P = self.num_grippers, self.num_points

        if env_ids is None:
            i_src, i_dst, i_mask = self.internal_src, self.internal_dst, self.internal_mask
            p_mask = self.point_mask
        else:
            i_src = self.internal_src[env_ids]
            i_dst = self.internal_dst[env_ids]
            i_mask = self.internal_mask[env_ids]
            p_mask = self.point_mask[env_ids]

        pos = split_group(tobs["position_vectors"], spec, "position_vectors")
        npos = split_group(tobs["norm_position_vectors"], spec, "position_vectors")
        nvel = split_group(tobs["norm_velocity_vectors"], spec, "velocity_vectors")

        grip_pos = pos["grippers"].reshape(B, G, 3)
        grip_npos = npos["grippers"].reshape(B, G, 3)
        obj_pos = pos["object_geometry"].reshape(B, P, 3)
        obj_npos = npos["object_geometry"].reshape(B, P, 3)
        tgt_npos = npos["target_geometry"].reshape(B, P, 3)

        nodes = {
            "object_geometry": NodeSet(pos=obj_pos, norm_pos=obj_npos, mask=p_mask),
            "grippers": NodeSet(pos=grip_pos, norm_pos=grip_npos),
        }

        edges = {
            ("object_geometry", "internal", "object_geometry"): EdgeSet(src=i_src, dst=i_dst, mask=i_mask)
        }
        if G > 1:
            pairs = [(i, j) for i in range(G) for j in range(G) if i != j]
            a_src = jnp.broadcast_to(jnp.asarray([p[0] for p in pairs], jnp.int32), (B, len(pairs)))
            a_dst = jnp.broadcast_to(jnp.asarray([p[1] for p in pairs], jnp.int32), (B, len(pairs)))
            edges[("grippers", "agent", "grippers")] = EdgeSet(
                src=a_src, dst=a_dst, mask=jnp.ones((B, len(pairs)))
            )
        # task edges: every valid point -> every gripper (knn_to_actuators_k=-1)
        t_src = jnp.broadcast_to(jnp.tile(jnp.arange(P, dtype=jnp.int32), G), (B, P * G))
        t_dst = jnp.broadcast_to(jnp.repeat(jnp.arange(G, dtype=jnp.int32), P), (B, P * G))
        t_mask = jnp.tile(p_mask, (1, G))
        edges[("object_geometry", "task", "grippers")] = EdgeSet(src=t_src, dst=t_dst, mask=t_mask)

        graph = HeteroGraph(nodes=nodes, edges=edges, output_node_type=self.output_mask_key)

        # ---------------- features (construct_input_vector:152-230) ---------
        one_hot = {
            "object_geometry": jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (B, P, 3)),
            "grippers": jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (B, G, 3)),
        }

        target = tgt_npos  # [B, P, 3]
        corr_obj = obj_npos - target if self.dist_as_pos else target

        # object velocities: root velocity broadcast per point
        if "object_geometry" in spec.names["velocity_vectors"]:
            v_obj = nvel["object_geometry"].reshape(B, 1, 3)
            v_obj = jnp.broadcast_to(v_obj, (B, P, 3))
            if self.angular_velocity:
                w_obj = jnp.broadcast_to(nvel["object_geometry_angular"].reshape(B, 1, 3), (B, P, 3))
            else:
                w_obj = jnp.zeros((B, P, 3))
        else:
            v_obj = jnp.zeros((B, P, 3))
            w_obj = jnp.zeros((B, P, 3))

        v_grip = nvel["grippers"].reshape(B, G, 3)
        if "grippers_angular" in spec.names["velocity_vectors"] and self.angular_velocity:
            w_grip = nvel["grippers_angular"].reshape(B, G, 3)
        else:
            w_grip = jnp.zeros((B, G, 3))

        vectors = {
            "object_geometry": jnp.stack([obj_npos, corr_obj, v_obj, w_obj], axis=2),  # [B,P,4,3]
            "grippers": jnp.stack(
                [grip_npos, jnp.zeros((B, G, 3)), v_grip, w_grip], axis=2
            ),
        }
        if self.training_noise and noise_key is not None:
            vectors = apply_training_noise(vectors, noise_key, self.training_noise_std)
        feats = GraphFeatures(scalars=one_hot, vectors=vectors)
        return graph, feats
