"""Padded heterogeneous graph batch — the L3 data structure.

JAX redesign of the reference's PyG `HeteroData` batches
(geometry_rl/modules/pyg_data/base_data.py): instead of per-env Python-built
graphs coalesced into one ragged batch, every tensor is dense and padded with
a static shape, vmap/jit-safe:

- node sets are [B, N_t, ...] per node type (N_t static, padded; `mask` marks
  real nodes when shapes vary per env — the multi-asset mechanism),
- edge sets are [B, E, 2] int32 index pairs LOCAL to their endpoint node types
  with a float mask (invalid edges point at node 0 with mask 0).

Edge keys are (src_type, level, dst_type) triples exactly like the reference's
EdgeType enums (rigid_tasks_data.py:32-47), because HEPi's message-passing
schedule is organized by edge LEVEL (internal / agent / task).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax.numpy as jnp

EdgeKey = Tuple[str, str, str]  # (src_type, level, dst_type)


class NodeSet(NamedTuple):
    pos: jnp.ndarray  # [B, N, 3] raw world positions
    norm_pos: jnp.ndarray  # [B, N, 3] normalized positions (NDVecNorm output)
    mask: Optional[jnp.ndarray] = None  # [B, N] 1.0 = real node (None = all real)

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[-2]


class EdgeSet(NamedTuple):
    src: jnp.ndarray  # [B, E] int32 into src node type
    dst: jnp.ndarray  # [B, E] int32 into dst node type
    mask: jnp.ndarray  # [B, E] float 1.0 = real edge

    @property
    def num_edges(self) -> int:
        return self.src.shape[-1]


class HeteroGraph(NamedTuple):
    nodes: Dict[str, NodeSet]
    edges: Dict[EdgeKey, EdgeSet]
    output_node_type: str  # node type read out by the policy (e.g. "grippers")

    @property
    def node_types(self):
        return list(self.nodes.keys())

    @property
    def edge_types(self):
        return list(self.edges.keys())


class GraphFeatures(NamedTuple):
    """Per-node-type input features built by the data layer
    (rigid_tasks_data.py `construct_input_vector`, concat_input_vector=False):
    scalars = one-hot node type; vectors = stacked geometric 3-vectors."""

    scalars: Dict[str, jnp.ndarray]  # [B, N_t, S]
    vectors: Dict[str, jnp.ndarray]  # [B, N_t, V, 3]

    def concat(self) -> Dict[str, jnp.ndarray]:
        """Flat per-node feature (concat_input_vector=True path): [B, N_t, S + 3V]."""
        out = {}
        for nt, s in self.scalars.items():
            v = self.vectors[nt]
            out[nt] = jnp.concatenate([s, v.reshape(v.shape[:-2] + (-1,))], axis=-1)
        return out
