"""Scene state and specs for the batched simulator.

This module replaces the Isaac Sim / geometry_orbit physics backend
(SURVEY.md §2.10) with explicit pytree state that `vmap`s over environments
and shard over a device mesh. Conventions:

- All state arrays carry a leading env axis B. Bodies/particles within an env
  are a second static axis.
- Quaternions are (w, x, y, z); positions are world-frame, per-env local
  (env origins do not exist — envs are independent coordinate frames, which
  is what every reference MDP term computes anyway via
  `root_pos_w - env_origins`).
- Specs (masses, joints, shapes, locked axes) are static per-task pytrees of
  regular arrays; anything per-env-varying (multi-asset shape padding) is a
  [B, ...] array inside the spec.

The reference surface covered (SURVEY.md §2.10):
  RigidObject.data.{root_pos_w, root_quat_w, root_lin_vel_w, root_ang_vel_w,
  default_root_state} -> RigidBodyState fields; write_root_{pose,velocity}
  _to_sim -> functional state updates; locked_{pos,rot}_axis bitmasks ->
  per-body axis masks; JointAttachmentCfg -> FixedJointSpec;
  ClothObject.data.points_* / Rope.data.link_* -> ParticleState.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class RigidBodyState(NamedTuple):
    """Batched rigid body states: [B, NB, ...]."""

    pos: jnp.ndarray  # [B, NB, 3]
    quat: jnp.ndarray  # [B, NB, 4] (w,x,y,z)
    lin_vel: jnp.ndarray  # [B, NB, 3]
    ang_vel: jnp.ndarray  # [B, NB, 3] world frame


class ParticleState(NamedTuple):
    """Batched particle states (cloth vertices / rope nodes): [B, NP, ...]."""

    pos: jnp.ndarray  # [B, NP, 3]
    vel: jnp.ndarray  # [B, NP, 3]


class SceneState(NamedTuple):
    bodies: RigidBodyState
    particles: Optional[ParticleState] = None


class RigidBodySpec(NamedTuple):
    """Static per-body parameters: [NB, ...] (broadcast over envs)."""

    inv_mass: jnp.ndarray  # [NB] 0 = kinematic/static
    inv_inertia: jnp.ndarray  # [NB, 3] diagonal body-frame inverse inertia
    gravity_scale: jnp.ndarray  # [NB] 1 = full gravity, 0 = disabled
    lin_damping: jnp.ndarray  # [NB]
    ang_damping: jnp.ndarray  # [NB]
    # axis locks: 1.0 = free, 0.0 = locked (orbit locked_*_axis bitmasks:
    # bit0=x, bit1=y, bit2=z — rigid_insertion_multi_env_cfg.py:84-125)
    free_pos: jnp.ndarray  # [NB, 3]
    free_rot: jnp.ndarray  # [NB, 3]


class FixedJointSpec(NamedTuple):
    """Fixed joints welding body pairs (JointAttachmentCfg equivalents).

    Anchors are local-frame points: the joint drives
    world(body_a, local_pos_a) == world(body_b, local_pos_b) and locks the
    initial relative orientation.
    """

    body_a: jnp.ndarray  # [NJ] int32 body indices
    body_b: jnp.ndarray  # [NJ]
    local_pos_a: jnp.ndarray  # [NJ, 3]
    local_pos_b: jnp.ndarray  # [NJ, 3]
    # relative orientation captured at attach time: q_rel = conj(q_a) * q_b,
    # possibly per-env if reset randomization rotates bodies independently
    rel_quat: jnp.ndarray  # [NJ, 4] or [B, NJ, 4]


def axis_mask_from_bits(bits: int) -> jnp.ndarray:
    """orbit locked-axis bitmask -> free-axis multiplier (1 free, 0 locked)."""
    return jnp.array(
        [0.0 if bits & 1 else 1.0, 0.0 if bits & 2 else 1.0, 0.0 if bits & 4 else 1.0],
        dtype=jnp.float32,
    )


def box_inertia(mass: float, size) -> jnp.ndarray:
    """Diagonal inertia of a solid box with full extents `size`."""
    sx, sy, sz = size
    return jnp.array(
        [
            mass / 12.0 * (sy * sy + sz * sz),
            mass / 12.0 * (sx * sx + sz * sz),
            mass / 12.0 * (sx * sx + sy * sy),
        ],
        dtype=jnp.float32,
    )


class ClothSolveSpec(NamedTuple):
    """Static description of the cloth position solve (hashable; shapes and
    constants baked into the fused kernel, sim/pallas_cloth.py)."""

    group_compliance: tuple  # one compliance per conflict-free distance group
    num_particles: int  # P (cloth only)
    num_bodies: int  # G gripper pseudo-particles appended after P
    iterations: int
    dt: float
    hook_radius: float
    hook_half_len: float
    hook_friction: float
