"""Rigid manipulation tasks: pushing, sliding, insertion, two-agent insertion.

JAX redesign of `geometry_rl/orbit/tasks/manipulation/rigid_tasks/`:
one generic `RigidEnv` parameterized by `RigidTaskCfg` covers all four gym
registrations (config/factory/__init__.py:36-47). The multi-asset "varying
shapes" mechanism (sim_utils.py round-robin spawner) is a static shape-id
assignment env->shape with padded geometry batches.

Frame conventions vs the reference: the stripped USD pegs were extruded along
local +x and the scene "stand placement" pitched everything by -pi/2 at reset
(event_cfg.py pitch ranges). Our procedural prisms extrude along local +z, so
the constant pitch disappears and reset randomization acts directly as world
yaw — the same MDP in a cleaner frame.

Scene bodies per env: [grippers (G), object, target(virtual), plate?]
- object: dynamic peg (mass 0.1 insertion / 3.0 pushing, lin damping 10,
  yaw-only rotation via locked_rot_axis=3; pushing also locks z via
  locked_pos_axis=4) — rigid_{insertion,pushing}_multi_env_cfg.py
- grippers: 10 kg sticks driven by root-velocity commands
  (mdp/actions.py CubeActionTerm), welded to the object for
  insertion/sliding/two-agent (JointAttachmentCfg), free for pushing
- target: static marker (all axes locked, no collision)
- plate: static hole plate (insertion only), contact via polygon SDF
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..sim.shapes import (
    PUSHING_SHAPE_NAMES,
    SHAPE_NAMES,
    ShapeSet,
    build_shape_set,
    ground_sdf,
    hole_plate_sdf,
    polygon_sdf_2d,
)
from ..sim.types import (
    FixedJointSpec,
    RigidBodySpec,
    RigidBodyState,
    SceneState,
    box_inertia,
)
from ..sim.xpbd import BodyPairContact, ContactSet, step_physics
from ..utils.math import (
    quat_apply,
    quat_conjugate,
    quat_error_magnitude,
    quat_from_euler_xyz,
    quat_identity,
    quat_mul,
    sample_uniform,
    transform_points,
)
from .base import ObsSpec, TimeStep


@dataclasses.dataclass(frozen=True)
class RigidTaskCfg:
    """Static task parameters. Defaults = insertion multi."""

    name: str = "rigid_insertion"
    num_envs: int = 40
    shapes: Tuple[str, ...] = SHAPE_NAMES
    episode_length: int = 100  # control steps (episode_length_s 4 / (dt*decimation))
    decimation: int = 4
    dt: float = 0.01
    warmup_steps: int = 5  # zero-action steps after reset (env cfg warmup_steps)
    iterations: int = 8  # solver_position_iteration_count

    # geometry (procedural stand-in for the stripped USD scales)
    shape_scale: float = 0.1
    shape_half_height: float = 0.05
    hole_clearance: float = 0.08
    plate_half_extent: float = 0.4
    plate_half_thickness: float = 0.05
    gripper_size: Tuple[float, float, float] = (0.025, 0.025, 0.5)

    # actions (mdp/actions.py + actions_cfg.py)
    num_grippers: int = 1
    linear_only: bool = False  # CubeActionLinearTerm (pushing, two-agent)
    z_action: bool = True
    rotation_axis: int = 2  # -1 = all axes
    action_linear_scale: float = 1.0
    action_angular_scale: float = 20.0
    action_max: float = 1.0

    # bodies
    attached: bool = True  # weld gripper(s) to object
    object_mass: float = 0.1
    object_lin_damping: float = 10.0
    object_ang_damping: float = 2.0
    object_free_pos_bits: int = 0  # locked_pos_axis bits
    object_free_rot_bits: int = 3  # locked_rot_axis bits
    gripper_mass: float = 10.0
    gripper_damping: float = 10.0
    gripper_locked_rot_bits: int = 3
    gripper_gravity: bool = True
    has_plate: bool = True
    ground: bool = True

    # reward (rewards_cfg.py / mdp/rewards.py)
    reward_type: str = "insertion"  # insertion | pushing | sliding
    reward_weight: float = -0.8
    n_last_steps: int = 2
    weight_n_last_steps: float = 5.0
    orientation_weight: float = 0.5
    weight_orientation_n_last_steps: float = 5.0
    z_weight: float = 0.5
    ee_weight: float = -0.2  # pushing only
    velocity_weight: float = 0.0  # sliding: -0.1
    action_rate_weight: float = 0.0  # sliding: -2e-3

    # velocity-pass material (scene_cfg.py RigidBodyMaterialCfg() — PhysX
    # defaults static=dynamic friction, restitution=0). 0 disables the pass
    # (round-1 quasi-static parity default); dynamic_friction_scale=1.0 gives
    # each contact a dynamic coefficient equal to its static one, matching
    # the reference's default material.
    restitution: float = 0.0
    dynamic_friction_scale: float = 0.0

    # reset randomization (event_cfg.py); tuples are (lo, hi)
    object_xy_range: Tuple[float, float] = (-1.0, 1.0)
    object_z_range: Tuple[float, float] = (1.0, 1.5)  # absolute z after reset
    object_yaw_range: Tuple[float, float] = (-3.14159265, 3.14159265)
    target_z: float = 0.25
    target_yaw_range: Tuple[float, float] = (-3.14159265, 3.14159265)
    gripper_reset_with_object: bool = True
    # two-agent: rotate the object+gripper group around the target
    # (world_frame_randomization.py reset_objects_uniform_around_origin)
    rotate_around_target: bool = False
    around_target_pitch_range: Tuple[float, float] = (-1.5707963, 0.0)

    @property
    def num_shapes(self) -> int:
        return len(self.shapes)

    @property
    def num_bodies(self) -> int:
        return self.num_grippers + 2 + (1 if self.has_plate else 0)

    @property
    def object_body(self) -> int:
        return self.num_grippers

    @property
    def target_body(self) -> int:
        return self.num_grippers + 1

    @property
    def plate_body(self) -> int:
        return self.num_grippers + 2

    @property
    def action_dim(self) -> int:
        return (3 if self.linear_only else 6) * self.num_grippers


class RigidEnvState(NamedTuple):
    scene: SceneState
    episode_step: jnp.ndarray  # [B] int32
    key: jax.Array
    prev_action: jnp.ndarray  # [B, A] (action_rate penalty)


def _axis_mask(bits: int) -> jnp.ndarray:
    return jnp.array(
        [0.0 if bits & 1 else 1.0, 0.0 if bits & 2 else 1.0, 0.0 if bits & 4 else 1.0], jnp.float32
    )


class RigidEnv:
    """Batched rigid-task environment; all methods are jit-safe pure fns."""

    def __init__(self, cfg: RigidTaskCfg):
        self.cfg = cfg
        B = cfg.num_envs
        self.shape_set: ShapeSet = build_shape_set(
            cfg.shapes, scale=cfg.shape_scale, half_height=cfg.shape_half_height
        )
        self.hole_set: ShapeSet = build_shape_set(
            cfg.shapes, scale=cfg.shape_scale, half_height=cfg.shape_half_height, clearance=cfg.hole_clearance
        )
        # round-robin multi-asset assignment (sim_utils.py:21-33)
        self.shape_ids = jnp.arange(B, dtype=jnp.int32) % cfg.num_shapes
        # per-env gathered geometry (constants)
        self.obj_points = self.shape_set.points[self.shape_ids]  # [B,P,3]
        self.obj_point_mask = self.shape_set.point_mask[self.shape_ids]
        self.obj_num_points = self.shape_set.num_points[self.shape_ids]
        self.obj_edges = self.shape_set.edges[self.shape_ids]
        self.obj_edge_mask = self.shape_set.edge_mask[self.shape_ids]
        self.obj_num_edges = self.shape_set.num_edges[self.shape_ids]
        self.obj_surface = self.shape_set.surface_points[self.shape_ids]
        self.hole_outline = self.hole_set.outline[self.shape_ids]  # [B,K,2]
        self.obj_outline = self.shape_set.outline[self.shape_ids]

        self.body_spec = self._build_body_spec()
        self.joints = self._build_joints() if cfg.attached else None
        self.obs_spec = self._build_obs_spec()

    # ------------------------------------------------------------------ spec

    def _build_body_spec(self) -> RigidBodySpec:
        cfg = self.cfg
        inv_mass, inv_inertia, grav, lind, angd, fpos, frot = [], [], [], [], [], [], []
        for _ in range(cfg.num_grippers):
            inv_mass.append(1.0 / cfg.gripper_mass)
            inv_inertia.append(1.0 / box_inertia(cfg.gripper_mass, cfg.gripper_size))
            grav.append(1.0 if cfg.gripper_gravity else 0.0)
            lind.append(cfg.gripper_damping)
            angd.append(cfg.gripper_damping)
            fpos.append(jnp.ones(3))
            frot.append(_axis_mask(cfg.gripper_locked_rot_bits))
        # object
        size = (2 * cfg.shape_scale, 2 * cfg.shape_scale, 2 * cfg.shape_half_height)
        inv_mass.append(1.0 / cfg.object_mass)
        inv_inertia.append(1.0 / box_inertia(cfg.object_mass, size))
        grav.append(1.0)
        lind.append(cfg.object_lin_damping)
        angd.append(cfg.object_ang_damping)
        fpos.append(_axis_mask(cfg.object_free_pos_bits))
        frot.append(_axis_mask(cfg.object_free_rot_bits))
        # target (+ plate): static
        n_static = 1 + (1 if cfg.has_plate else 0)
        for _ in range(n_static):
            inv_mass.append(0.0)
            inv_inertia.append(jnp.zeros(3))
            grav.append(0.0)
            lind.append(0.0)
            angd.append(0.0)
            fpos.append(jnp.zeros(3))
            frot.append(jnp.zeros(3))
        return RigidBodySpec(
            inv_mass=jnp.asarray(inv_mass, jnp.float32),
            inv_inertia=jnp.stack([jnp.asarray(x, jnp.float32) for x in inv_inertia]),
            gravity_scale=jnp.asarray(grav, jnp.float32),
            lin_damping=jnp.asarray(lind, jnp.float32),
            ang_damping=jnp.asarray(angd, jnp.float32),
            free_pos=jnp.stack(fpos),
            free_rot=jnp.stack(frot),
        )

    def _gripper_anchor(self, i: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(local on gripper, local on object) weld anchors.

        Single gripper: stick hangs above the peg (suction), anchored at its
        lower end to the peg top (grippers_cfg.py local_pos0/local_pos1).
        Two agents: sticks attach to the peg's +/-y sides
        (TwoSuctionGrippers.local_pos1 = (0, +/-4, 0) scaled).
        """
        cfg = self.cfg
        if cfg.num_grippers == 1:
            lp_g = jnp.asarray([0.0, 0.0, -0.5 * cfg.gripper_size[2]])
            lp_o = jnp.asarray([0.0, 0.0, cfg.shape_half_height])
        else:
            # two-agent sticks lie along y: anchor at the stick's inner y-end
            side = 1.0 if i == 0 else -1.0
            lp_g = jnp.asarray([0.0, -side * 0.5 * cfg.gripper_size[1], 0.0])
            lp_o = jnp.asarray([0.0, side * cfg.shape_scale, 0.0])
        return lp_g, lp_o

    def _build_joints(self) -> FixedJointSpec:
        cfg = self.cfg
        lpa, lpb, rel = [], [], []
        for i in range(cfg.num_grippers):
            lp_g, lp_o = self._gripper_anchor(i)
            lpa.append(lp_g)
            lpb.append(lp_o)
            if cfg.num_grippers == 1:
                rel.append(jnp.asarray([1.0, 0.0, 0.0, 0.0]))
            else:
                # two-agent sticks lie along y: rotate stick z-axis onto +/-y
                rel.append(jnp.asarray([1.0, 0.0, 0.0, 0.0]))
        return FixedJointSpec(
            body_a=jnp.arange(cfg.num_grippers, dtype=jnp.int32),
            body_b=jnp.full((cfg.num_grippers,), cfg.object_body, jnp.int32),
            local_pos_a=jnp.stack(lpa),
            local_pos_b=jnp.stack(lpb),
            rel_quat=jnp.stack(rel),
        )

    def _build_obs_spec(self) -> ObsSpec:
        cfg = self.cfg
        P = self.obj_points.shape[1]
        E = self.obj_edges.shape[1]
        G = cfg.num_grippers
        names = {
            "scalars": ["object_target_distances"],
            "position_vectors": ["grippers", "object_geometry", "target_geometry"],
            "infos": ["object_num_points", "object_geometry_edges", "object_num_edges"],
        }
        dims = {
            "scalars": [P],
            "position_vectors": [3 * G, 3 * P, 3 * P],
            "infos": [1, 2 * E, 1],
        }
        if cfg.name == "rigid_insertion_two_agents":
            # FullSceneObservationTwoAgentsCfg: velocities = grippers only
            names["velocity_vectors"] = ["grippers"]
            dims["velocity_vectors"] = [3 * G]
        elif cfg.name == "rigid_sliding":
            # NoObjectVelObservationCfg
            names["velocity_vectors"] = ["grippers", "grippers_angular"]
            dims["velocity_vectors"] = [3 * G, 3 * G]
        else:
            names["velocity_vectors"] = [
                "grippers",
                "grippers_angular",
                "object_geometry",
                "object_geometry_angular",
            ]
            dims["velocity_vectors"] = [3 * G, 3 * G, 3, 3]
        return ObsSpec(names=names, dims=dims)

    # ----------------------------------------------------------------- reset

    def _sample_poses(self, key: jax.Array):
        """Sample object/gripper/target poses (event_cfg.py randomization)."""
        cfg = self.cfg
        B = cfg.num_envs
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)

        obj_xy = sample_uniform(k1, cfg.object_xy_range[0], cfg.object_xy_range[1], (B, 2))
        obj_z = sample_uniform(k2, cfg.object_z_range[0], cfg.object_z_range[1], (B, 1))
        obj_pos = jnp.concatenate([obj_xy, obj_z], axis=-1)
        obj_yaw = sample_uniform(k3, cfg.object_yaw_range[0], cfg.object_yaw_range[1], (B,))
        obj_quat = quat_from_euler_xyz(jnp.zeros(B), jnp.zeros(B), obj_yaw)

        tgt_pos = jnp.concatenate(
            [jnp.zeros((B, 2)), jnp.full((B, 1), cfg.target_z)], axis=-1
        )
        tgt_yaw = sample_uniform(k4, cfg.target_yaw_range[0], cfg.target_yaw_range[1], (B,))
        tgt_quat = quat_from_euler_xyz(jnp.zeros(B), jnp.zeros(B), tgt_yaw)

        if cfg.rotate_around_target:
            # two-agent: rotate the object+grippers group around the target in
            # the upper hemisphere (event_cfg.py:199-214)
            kp, ky = jax.random.split(k5)
            pitch = sample_uniform(kp, cfg.around_target_pitch_range[0], cfg.around_target_pitch_range[1], (B,))
            yaw = sample_uniform(ky, -jnp.pi, jnp.pi, (B,))
            rot = quat_mul(
                quat_from_euler_xyz(jnp.zeros(B), jnp.zeros(B), yaw),
                quat_from_euler_xyz(jnp.zeros(B), pitch, jnp.zeros(B)),
            )
            obj_pos = tgt_pos + quat_apply(rot, obj_pos - tgt_pos)
            obj_quat = quat_mul(rot, obj_quat)
        return obj_pos, obj_quat, tgt_pos, tgt_quat

    def _assemble_scene(self, obj_pos, obj_quat, tgt_pos, tgt_quat) -> SceneState:
        cfg = self.cfg
        B = cfg.num_envs
        NB = cfg.num_bodies
        pos = jnp.zeros((B, NB, 3))
        quat = jnp.broadcast_to(quat_identity(), (B, NB, 4))

        for i in range(cfg.num_grippers):
            if cfg.attached:
                # grippers placed at their weld pose relative to the object
                lp_g, lp_o = self._gripper_anchor(i)
                anchor_world = obj_pos + quat_apply(obj_quat, jnp.broadcast_to(lp_o, (B, 3)))
                g_pos = anchor_world - quat_apply(obj_quat, jnp.broadcast_to(lp_g, (B, 3)))
                pos = pos.at[:, i].set(g_pos)
                quat = quat.at[:, i].set(obj_quat)
            else:
                # pushing: stick behind the object in the plane
                # (PushingGrippers init offset, rigid_pushing_multi_env_cfg)
                offset = jnp.asarray([-0.4, 0.0, 0.0])
                pos = pos.at[:, i].set(obj_pos + offset)
                quat = quat.at[:, i].set(jnp.broadcast_to(quat_identity(), (B, 4)))
        pos = pos.at[:, cfg.object_body].set(obj_pos)
        quat = quat.at[:, cfg.object_body].set(obj_quat)
        pos = pos.at[:, cfg.target_body].set(tgt_pos)
        quat = quat.at[:, cfg.target_body].set(tgt_quat)
        if cfg.has_plate:
            pos = pos.at[:, cfg.plate_body].set(tgt_pos)
            quat = quat.at[:, cfg.plate_body].set(tgt_quat)
        return SceneState(
            bodies=RigidBodyState(
                pos=pos, quat=quat, lin_vel=jnp.zeros((B, NB, 3)), ang_vel=jnp.zeros((B, NB, 3))
            )
        )

    def reset(self, key: jax.Array) -> RigidEnvState:
        cfg = self.cfg
        key, sub = jax.random.split(key)
        scene = self._assemble_scene(*self._sample_poses(sub))
        state = RigidEnvState(
            scene=scene,
            episode_step=jnp.zeros((cfg.num_envs,), jnp.int32),
            key=key,
            prev_action=jnp.zeros((cfg.num_envs, cfg.action_dim)),
        )
        for _ in range(cfg.warmup_steps):
            state = state._replace(scene=self._physics(state.scene, zero_vel=True))
        return state

    # ------------------------------------------------------------------ step

    def _contacts(self, scene: SceneState):
        """Build this step's contact sets (closures capture per-env geometry
        and the current static poses)."""
        cfg = self.cfg
        contacts = []
        pair_contacts = []
        if cfg.ground:
            contacts.append(
                ContactSet(
                    body=cfg.object_body, local_points=self.obj_surface, sdf=ground_sdf, friction=0.5,
                    restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.5,
                )
            )
        if cfg.has_plate:
            plate_pos = scene.bodies.pos[:, cfg.plate_body]
            plate_quat = scene.bodies.quat[:, cfg.plate_body]
            outline = self.hole_outline
            half = cfg.plate_half_thickness

            def plate_sdf(world_pts):
                local = quat_apply(quat_conjugate(plate_quat)[:, None, :], world_pts - plate_pos[:, None, :])
                phi, n_local = jax.vmap(
                    lambda p, o: hole_plate_sdf(
                        p, o, None, plate_half_extent=cfg.plate_half_extent, plate_top=half, plate_bottom=-half
                    )
                )(local, outline)
                n_world = quat_apply(plate_quat[:, None, :], n_local)
                return phi, n_world

            contacts.append(
                ContactSet(
                    body=cfg.object_body, local_points=self.obj_surface, sdf=plate_sdf, friction=0.3,
                    restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.3,
                )
            )
        if not cfg.attached:
            # pushing: gripper stick vs object prism (both ways via pair contact)
            sx, sy, sz = cfg.gripper_size
            corners = jnp.asarray(
                [[x, y, z] for x in (-sx / 2, 0, sx / 2) for y in (-sy / 2, sy / 2) for z in (-sz / 2, 0, sz / 2)]
            )
            outline = self.obj_outline
            hh = cfg.shape_half_height

            def obj_sdf(local_pts):
                # prism SDF in the object's local frame
                poly = jax.vmap(polygon_sdf_2d)(local_pts[..., :2], outline)
                dz = jnp.abs(local_pts[..., 2]) - hh
                phi = jnp.maximum(poly, dz)
                # normal: in-plane from polygon gradient approx, z from slab
                eps = 1e-4
                gx = jax.vmap(polygon_sdf_2d)(local_pts[..., :2] + jnp.asarray([eps, 0.0]), outline) - jax.vmap(
                    polygon_sdf_2d
                )(local_pts[..., :2] - jnp.asarray([eps, 0.0]), outline)
                gy = jax.vmap(polygon_sdf_2d)(local_pts[..., :2] + jnp.asarray([0.0, eps]), outline) - jax.vmap(
                    polygon_sdf_2d
                )(local_pts[..., :2] - jnp.asarray([0.0, eps]), outline)
                in_plane = poly > dz
                n = jnp.stack(
                    [
                        jnp.where(in_plane, gx / (2 * eps), 0.0),
                        jnp.where(in_plane, gy / (2 * eps), 0.0),
                        jnp.where(in_plane, 0.0, jnp.sign(local_pts[..., 2])),
                    ],
                    axis=-1,
                )
                n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
                return phi, n

            for i in range(cfg.num_grippers):
                pair_contacts.append(
                    BodyPairContact(
                        body_points=i, body_sdf=cfg.object_body, local_points=corners, sdf=obj_sdf, friction=0.6,
                        restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.6,
                    )
                )
        return contacts, pair_contacts

    def _physics(self, scene: SceneState, zero_vel: bool = False) -> SceneState:
        cfg = self.cfg
        if zero_vel:
            vel = jnp.zeros_like(scene.bodies.lin_vel)
            scene = scene._replace(bodies=scene.bodies._replace(lin_vel=vel, ang_vel=jnp.zeros_like(vel)))
        contacts, pair_contacts = self._contacts(scene)
        return step_physics(
            scene,
            self.body_spec,
            cfg.dt,
            cfg.decimation,
            joints=self.joints,
            contacts=contacts,
            pair_contacts=pair_contacts,
            iterations=cfg.iterations,
        )

    def _apply_action(self, scene: SceneState, action: jnp.ndarray) -> SceneState:
        """CubeActionTerm semantics (mdp/actions.py:79-108): clamp, decompose
        the angular part around the gripper's position, write root velocity."""
        cfg = self.cfg
        a = jnp.clip(action, -cfg.action_max, cfg.action_max)
        per = 3 if cfg.linear_only else 6
        lin_vel = scene.bodies.lin_vel
        ang_vel = scene.bodies.ang_vel
        for i in range(cfg.num_grippers):
            ai = a[:, i * per : (i + 1) * per]
            v = ai[:, :3] * cfg.action_linear_scale
            if not cfg.z_action:
                v = v.at[:, 2].set(0.0)
            lin_vel = lin_vel.at[:, i].set(v)
            if cfg.linear_only:
                omega = jnp.zeros_like(v)
            else:
                # omega = (r x v_tangential) / |r|^2, r = gripper position
                r = scene.bodies.pos[:, i]
                vr = ai[:, 3:]
                r2 = jnp.maximum(jnp.sum(r * r, axis=-1, keepdims=True), 1e-9)
                v_par = (jnp.sum(vr * r, axis=-1, keepdims=True) / r2) * r
                v_tan = vr - v_par
                omega = jnp.cross(r, v_tan) / r2 * cfg.action_angular_scale
                if cfg.rotation_axis > -1:
                    mask = jnp.zeros(3).at[cfg.rotation_axis].set(1.0)
                    omega = omega * mask
            ang_vel = ang_vel.at[:, i].set(omega)
        return scene._replace(bodies=scene.bodies._replace(lin_vel=lin_vel, ang_vel=ang_vel))

    # ------------------------------------------------------------- obs/reward

    def _observe(self, state: RigidEnvState) -> Dict[str, jnp.ndarray]:
        cfg = self.cfg
        B = cfg.num_envs
        bodies = state.scene.bodies
        obj_pos = bodies.pos[:, cfg.object_body]
        obj_quat = bodies.quat[:, cfg.object_body]
        tgt_pos = bodies.pos[:, cfg.target_body]
        tgt_quat = bodies.quat[:, cfg.target_body]

        obj_pts = transform_points(self.obj_points, obj_pos, obj_quat)  # [B,P,3]
        tgt_pts = transform_points(self.obj_points, tgt_pos, tgt_quat)

        grip_pos = bodies.pos[:, : cfg.num_grippers].reshape(B, -1)
        grip_vel = bodies.lin_vel[:, : cfg.num_grippers].reshape(B, -1)
        grip_ang = bodies.ang_vel[:, : cfg.num_grippers].reshape(B, -1)

        scalars = jnp.linalg.norm(obj_pts - tgt_pts, axis=-1)  # [B,P]

        position_vectors = jnp.concatenate(
            [grip_pos, obj_pts.reshape(B, -1), tgt_pts.reshape(B, -1)], axis=-1
        )
        if cfg.name == "rigid_insertion_two_agents":
            velocity_vectors = grip_vel
        elif cfg.name == "rigid_sliding":
            velocity_vectors = jnp.concatenate([grip_vel, grip_ang], axis=-1)
        else:
            velocity_vectors = jnp.concatenate(
                [grip_vel, grip_ang, bodies.lin_vel[:, cfg.object_body], bodies.ang_vel[:, cfg.object_body]],
                axis=-1,
            )
        infos = jnp.concatenate(
            [
                self.obj_num_points[:, None].astype(jnp.float32),
                self.obj_edges.reshape(B, -1).astype(jnp.float32),
                self.obj_num_edges[:, None].astype(jnp.float32),
            ],
            axis=-1,
        )
        return {
            "scalars": scalars,
            "position_vectors": position_vectors,
            "velocity_vectors": velocity_vectors,
            "infos": infos,
        }

    def _reward(self, state: RigidEnvState, action: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        bodies = state.scene.bodies
        obj_pos = bodies.pos[:, cfg.object_body]
        tgt_pos = bodies.pos[:, cfg.target_body]
        dvec = obj_pos - tgt_pos
        distance = jnp.linalg.norm(dvec, axis=-1)
        ori_dist = quat_error_magnitude(bodies.quat[:, cfg.object_body], bodies.quat[:, cfg.target_body])

        in_last = state.episode_step >= cfg.episode_length - cfg.n_last_steps
        w_last = jnp.where(in_last, cfg.weight_n_last_steps, 1.0)
        w_ori_last = jnp.where(in_last, cfg.weight_orientation_n_last_steps, 1.0)

        if cfg.reward_type == "insertion":
            # mdp/rewards.py object_insertion:98-136
            z_dist = jnp.abs(dvec[:, 2])
            r = w_last * distance + cfg.orientation_weight * (w_ori_last * ori_dist) + cfg.z_weight * z_dist
            reward = cfg.reward_weight * r
        elif cfg.reward_type == "pushing":
            # object_target_distance + object_ee_distance (rewards_cfg.py:74-96)
            r = w_last * distance + cfg.orientation_weight * (w_last * ori_dist)
            ee = jnp.linalg.norm(obj_pos - bodies.pos[:, 0], axis=-1)
            reward = cfg.reward_weight * r + cfg.ee_weight * ee
        elif cfg.reward_type == "sliding":
            r = w_last * distance + cfg.orientation_weight * (w_last * ori_dist)
            vel = jnp.linalg.norm(bodies.lin_vel[:, cfg.object_body], axis=-1) + jnp.linalg.norm(
                bodies.ang_vel[:, cfg.object_body], axis=-1
            )
            act_rate = jnp.sum((action - state.prev_action) ** 2, axis=-1)
            reward = cfg.reward_weight * r + cfg.velocity_weight * vel + cfg.action_rate_weight * act_rate
        else:
            raise ValueError(cfg.reward_type)
        return reward

    # -------------------------------------------------------------- full step

    @partial(jax.jit, static_argnums=0)
    def step(self, state: RigidEnvState, action: jnp.ndarray) -> Tuple[RigidEnvState, TimeStep]:
        cfg = self.cfg
        scene = self._apply_action(state.scene, action)
        scene = self._physics(scene)
        stepped = state._replace(scene=scene, episode_step=state.episode_step + 1)

        reward = self._reward(stepped, action)
        done = stepped.episode_step >= cfg.episode_length

        # auto-reset done envs (randomization manager mode="reset")
        key, sub = jax.random.split(stepped.key)
        fresh = self._assemble_scene(*self._sample_poses(sub))
        if cfg.warmup_steps > 0:
            # NOTE: warmup on auto-reset is skipped (matches RLTaskEnv, which
            # warms up only on full resets through the wrapper)
            pass
        d3 = done[:, None, None]
        new_bodies = RigidBodyState(
            pos=jnp.where(d3, fresh.bodies.pos, scene.bodies.pos),
            quat=jnp.where(d3, fresh.bodies.quat, scene.bodies.quat),
            lin_vel=jnp.where(d3, fresh.bodies.lin_vel, scene.bodies.lin_vel),
            ang_vel=jnp.where(d3, fresh.bodies.ang_vel, scene.bodies.ang_vel),
        )
        new_state = RigidEnvState(
            scene=SceneState(bodies=new_bodies),
            episode_step=jnp.where(done, 0, stepped.episode_step),
            key=key,
            prev_action=jnp.where(done[:, None], 0.0, action),
        )
        obs = self._observe(new_state)
        # pre-reset object->target distance: the task-success diagnostic
        # (paper-style success = final distance under a threshold)
        dist = jnp.linalg.norm(
            scene.bodies.pos[:, cfg.object_body] - scene.bodies.pos[:, cfg.target_body], axis=-1
        )
        info = {"episode_step": new_state.episode_step, "object_target_distance": dist}
        return new_state, TimeStep(obs=obs, reward=reward, done=done, info=info)

    @partial(jax.jit, static_argnums=0)
    def observe(self, state: RigidEnvState) -> Dict[str, jnp.ndarray]:
        return self._observe(state)


# ---------------------------------------------------------------------------
# task registrations (config/factory/__init__.py gym IDs)
# ---------------------------------------------------------------------------


def rigid_insertion_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    return RigidTaskCfg(name="rigid_insertion", num_envs=num_envs, **kw)


def rigid_insertion_two_agents_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    kw.setdefault("num_grippers", 2)
    kw.setdefault("linear_only", True)
    kw.setdefault("z_action", True)
    kw.setdefault("object_free_rot_bits", 3)
    kw.setdefault("gripper_locked_rot_bits", 7)
    kw.setdefault("gripper_gravity", False)
    kw.setdefault("gripper_size", (0.025, 0.15, 0.025))
    kw.setdefault("reward_type", "insertion")
    kw.setdefault("orientation_weight", 0.1)
    kw.setdefault("weight_orientation_n_last_steps", 7.5)
    kw.setdefault("z_weight", 0.0)
    kw.setdefault("object_xy_range", (0.25, 0.75))
    kw.setdefault("object_z_range", (0.5, 1.25))
    kw.setdefault("rotate_around_target", True)
    return RigidTaskCfg(name="rigid_insertion_two_agents", num_envs=num_envs, **kw)


def rigid_pushing_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    kw.setdefault("shapes", PUSHING_SHAPE_NAMES)
    kw.setdefault("attached", False)
    kw.setdefault("linear_only", True)
    kw.setdefault("z_action", False)
    kw.setdefault("object_mass", 3.0)
    kw.setdefault("object_ang_damping", 10.0)
    kw.setdefault("object_free_pos_bits", 4)
    kw.setdefault("object_free_rot_bits", 3)
    kw.setdefault("gripper_locked_rot_bits", 7)
    kw.setdefault("gripper_gravity", False)
    kw.setdefault("gripper_size", (0.5, 0.05, 0.05))
    kw.setdefault("has_plate", False)
    kw.setdefault("reward_type", "pushing")
    kw.setdefault("n_last_steps", 5)
    kw.setdefault("weight_n_last_steps", 10.0)
    kw.setdefault("orientation_weight", 0.1)
    kw.setdefault("object_xy_range", (-0.5, 0.5))
    kw.setdefault("object_z_range", (0.06, 0.06),)
    kw.setdefault("target_z", 0.06)
    kw.setdefault("warmup_steps", 5)  # *_env_cfg warmup_steps: 5
    return RigidTaskCfg(name="rigid_pushing", num_envs=num_envs, **kw)


def rigid_sliding_cfg(num_envs: int = 40, **kw) -> RigidTaskCfg:
    kw.setdefault("shapes", ("L",))
    kw.setdefault("attached", True)
    kw.setdefault("linear_only", False)
    kw.setdefault("z_action", False)
    kw.setdefault("rotation_axis", 2)
    kw.setdefault("object_mass", 1.0)
    kw.setdefault("object_ang_damping", 10.0)
    kw.setdefault("object_free_pos_bits", 4)
    kw.setdefault("object_free_rot_bits", 3)
    kw.setdefault("has_plate", False)
    kw.setdefault("reward_type", "sliding")
    kw.setdefault("n_last_steps", 2)
    kw.setdefault("weight_n_last_steps", 5.0)
    kw.setdefault("orientation_weight", 0.5)
    kw.setdefault("velocity_weight", -0.1)
    kw.setdefault("action_rate_weight", -2e-3)
    kw.setdefault("object_xy_range", (-1.0, 1.0))
    kw.setdefault("object_z_range", (0.06, 0.06))
    kw.setdefault("target_z", 0.06)
    kw.setdefault("warmup_steps", 5)  # *_env_cfg warmup_steps: 5
    return RigidTaskCfg(name="rigid_sliding", num_envs=num_envs, **kw)


TASK_REGISTRY = {
    # gym IDs from rigid_tasks/config/factory/__init__.py:36-47
    "rigid_insertion": rigid_insertion_cfg,
    "rigid_insertion_two_agents": rigid_insertion_two_agents_cfg,
    "rigid_pushing": rigid_pushing_cfg,
    "rigid_sliding": rigid_sliding_cfg,
}
