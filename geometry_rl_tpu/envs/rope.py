"""Rope manipulation tasks: closing (wrap a pole) and shaping (match a curve).

JAX redesign of `geometry_rl/orbit/tasks/manipulation/rope_tasks/`: the
articulated PhysX rope (RopeShapeCfg: 40 links / 5 m closing, 80 links / 10 m
shaping, grippers_cfg.py) becomes an XPBD particle chain with distance
constraints; the two gripper cubes are rigid bodies welded to the end links by
attachment constraints (JointAttachmentCfg with attached_link_idx 0 / L-1).

Observation groups (ClosingObservationsCfg / ShapingObservationsCfg):
  scalars           = rope_target_distances_obs == zeros [B, 1] (placeholder,
                      mdp/observations.py:190-199)
  position_vectors  = grippers (2x3) | links (Lx3) | target_geometry (Lx3)
                      (hanger pos repeated per link for closing; yaw-rotated
                      W-curve points for shaping)
  velocity_vectors  = grippers (2x3) | links (Lx3)

Rewards (rewards_cfg.py):
  closing: -2 * gripper xy distance (last 20 steps) - 0.8 * |rope centroid -
           hanger|_xy - 1e-2 * mean link speed - 1e-3 * action rate
  shaping: -1 * shape-descriptor MSE (x5 in last 10 steps) - 1e-4 action rate

The LASA "WShape" target curve (pyLasaDataset, unavailable offline) is
re-authored as a procedural smoothed W resampled to the link count and scaled
to the rope length (generate_positions_UV semantics, observations.py:26-61).
"""

from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sim.shapes import ground_sdf
from ..sim.types import ParticleState, RigidBodySpec, RigidBodyState, SceneState, box_inertia
from ..sim.xpbd import BodyAttachment, DistanceGroup, ParticleSDFContact, ParticleSpec, step_physics
from ..utils.math import quat_from_euler_xyz, quat_identity, quat_mul, sample_uniform
from .base import ObsSpec, TimeStep


def w_shape_curve(num_points: int, length: float, z: float = 0.1) -> np.ndarray:
    """Procedural stand-in for the LASA WShape demo: a smoothed W polyline
    resampled to `num_points` with total arc length `length`."""
    ctrl = np.array(
        [(0.0, 0.0), (1.0, -1.6), (2.0, -0.3), (3.0, -1.6), (4.0, 0.0)], dtype=np.float64
    )
    # densify with Catmull-Rom-ish smoothing (quadratic bezier per corner)
    dense = []
    n_seg = 200
    for i in range(len(ctrl) - 1):
        a, b = ctrl[i], ctrl[i + 1]
        for t in np.linspace(0, 1, n_seg, endpoint=False):
            dense.append(a + t * (b - a))
    dense.append(ctrl[-1])
    dense = np.asarray(dense)
    # mild smoothing
    k = 41
    kernel = np.ones(k) / k
    sm = dense.copy()
    for d in range(2):
        sm[:, d] = np.convolve(np.pad(dense[:, d], (k // 2, k // 2), mode="edge"), kernel, mode="valid")
    # arc-length resample
    seg = np.linalg.norm(np.diff(sm, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    targets = np.linspace(0, total, num_points)
    pts = np.stack([np.interp(targets, s, sm[:, 0]), np.interp(targets, s, sm[:, 1])], axis=1)
    pts *= length / total
    pts -= pts.mean(0)  # center
    out = np.concatenate([pts, np.full((num_points, 1), z)], axis=1)
    return out.astype(np.float32)


def load_target_curve(path: str, num_links: int, rope_length: float, z: float = 0.1) -> np.ndarray:
    """Load a shaping target polyline from a file, reproducing the reference's
    LASA pipeline EXACTLY (rope_tasks/mdp/observations.py:26-60): index-space
    linear interpolation of the raw 2D trace to `num_links` points, scaled so
    the total polyline length equals `rope_length`, with constant z appended.

    Supported formats:
      - `.mat`  — a pyLasaDataset shape file (e.g. WShape.mat): demo 0's `pos`
                  [2, T] trace is used, exactly as the reference's
                  `lasa.DataSet.WShape.demos[0].pos`.
      - `.npy` / `.npz` (first array) / `.csv` / `.json` — a [2, T] or [T, 2]
                  (or [T, 3]; z column ignored) polyline.

    The actual LASA dataset cannot be vendored in this environment (zero
    egress, not on disk) — this loader makes the env accept the real data
    byte-for-byte when available; `w_shape_curve` is the documented
    procedural fallback."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mat":
        import scipy.io

        mat = scipy.io.loadmat(path)
        demo0 = mat["demos"][0, 0]
        # pyLasaDataset layout: demos is a [1, D] cell of structs with field
        # 'pos' [2, T]; loadmat exposes struct fields by name
        pos = np.asarray(demo0["pos"][0, 0] if demo0.dtype.names else demo0, dtype=np.float64)
    else:
        if ext == ".npy":
            pos = np.load(path)
        elif ext == ".npz":
            data = np.load(path)
            pos = data[list(data.keys())[0]]
        elif ext == ".json":
            import json

            with open(path) as f:
                pos = np.asarray(json.load(f), dtype=np.float64)
        else:  # csv / txt
            pos = np.loadtxt(path, delimiter=",")
        pos = np.asarray(pos, dtype=np.float64)
        if pos.ndim != 2:
            raise ValueError(f"target curve must be 2D, got shape {pos.shape}")
        if pos.shape[0] not in (2, 3):  # [T, 2] / [T, 3] -> [2, T]
            pos = pos.T
        pos = pos[:2]
    # index-space interpolation (observations.py:37-45 interp1d over indices)
    t = np.arange(pos.shape[1])
    interp_points = np.linspace(0.0, pos.shape[1] - 1, num_links)
    x = np.interp(interp_points, t, pos[0])
    y = np.interp(interp_points, t, pos[1])
    pts = np.stack([x, y], axis=1)
    # scale total polyline length to rope_length (observations.py:48-56)
    total = np.linalg.norm(np.diff(pts, axis=0), axis=1).sum()
    pts *= rope_length / total
    out = np.concatenate([pts, np.full((num_links, 1), z)], axis=1)
    return out.astype(np.float32)


def shape_descriptor(positions_2d: jnp.ndarray) -> jnp.ndarray:
    """Rope shape descriptor (mdp/rewards.py:143-182): segment-to-segment
    angles, segment-to-global angles, midpoint-relative vectors + distances.
    positions_2d: [L, 2] -> flat descriptor."""
    vectors = positions_2d[1:] - positions_2d[:-1]
    norms = jnp.linalg.norm(vectors, axis=1, keepdims=True)
    unit = vectors / (norms + 1e-6)

    cos_seg = jnp.clip(jnp.sum(unit[:-1] * unit[1:], axis=1), -1.0, 1.0)
    ang_seg = jnp.arccos(cos_seg)

    gvec = positions_2d[-1] - positions_2d[0]
    gunit = gvec / jnp.maximum(jnp.linalg.norm(gvec), 1e-6)
    cos_glob = jnp.clip(jnp.sum(unit * gunit, axis=1), -1.0, 1.0)
    ang_glob = jnp.arccos(cos_glob)

    mid = 0.5 * (positions_2d[0] + positions_2d[-1])
    rel = positions_2d - mid
    rel_dist = jnp.linalg.norm(rel, axis=1)
    return jnp.concatenate([ang_seg, ang_glob, rel.reshape(-1), rel_dist])


def yaw_rotate_2d(points: jnp.ndarray, yaw: jnp.ndarray) -> jnp.ndarray:
    """Rotate [..., N, 3] points about z by per-batch yaw [...]."""
    c, s = jnp.cos(yaw)[..., None], jnp.sin(yaw)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return jnp.stack([c * x - s * y, s * x + c * y, z], axis=-1)


@dataclasses.dataclass(frozen=True)
class RopeTaskCfg:
    name: str = "rope_closing"
    num_envs: int = 40
    num_links: int = 40  # ClosingGrippers.ROPE_NUM_LINKS (shaping: 80)
    rope_length: float = 5.0  # (shaping: 10.0)
    episode_length: int = 200
    decimation: int = 2
    dt: float = 0.01
    iterations: int = 8
    warmup_steps: int = 10  # rope_* cfg warmup_steps: 10

    link_mass: float = 0.05
    rope_damping: float = 2.0
    gripper_mass: float = 10.0
    gripper_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    rope_z: float = 0.1
    ground_z: float = -0.5
    # velocity-pass material (scene_cfg.py RigidBodyMaterialCfg() defaults:
    # dynamic == static friction, restitution 0). 0 disables the pass.
    restitution: float = 0.0
    dynamic_friction_scale: float = 0.0

    # closing scene
    hanger_pos: Tuple[float, float, float] = (2.0, 3.0, 0.0)
    hanger_radius: float = 0.15
    hanger_xy_range: float = 0.5
    around_hanger_yaw: Tuple[float, float] = (-math.pi, math.pi)
    center_rot_range: Tuple[float, float] = (-math.pi / 4, math.pi / 4)

    # shaping
    # optional target-curve data file (LASA WShape.mat / npy / csv / json —
    # see load_target_curve). None = procedural w_shape_curve fallback.
    target_curve_file: str = ""
    target_yaw_range: Tuple[float, float] = (-math.pi / 2, math.pi / 2)
    # two-sided offset ranges (event_cfg.py angle_range 4-tuple)
    shaping_rot_ranges: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (-math.pi / 2, -math.pi / 4),
        (math.pi / 4, math.pi / 2),
    )

    # rewards
    closing_grip_weight: float = -2.0
    closing_grip_last_steps: int = 20
    closing_wrap_weight: float = -0.8
    closing_vel_weight: float = -1e-2
    closing_action_rate_weight: float = -1e-3
    shaping_weight: float = -1.0
    shaping_last_steps: int = 10
    shaping_weight_last: float = 5.0
    shaping_action_rate_weight: float = -1e-4

    action_max: float = 1.0
    # rope CubeActionTerm: clamp(+-1) * 5.0, z zeroed (rope_tasks/mdp/
    # actions.py:31-72 action_scale=5.0, action_dim=3)
    action_linear_scale: float = 5.0

    @property
    def num_grippers(self) -> int:
        return 2

    @property
    def action_dim(self) -> int:
        return 3 * self.num_grippers  # rope_tasks/mdp/actions.py:40-41 (3D)

    @property
    def link_spacing(self) -> float:
        # (length/links - radius) spacing: 0.1 for both tasks (grippers_cfg.py)
        return self.rope_length / self.num_links - 0.025

    @property
    def is_shaping(self) -> bool:
        return self.name == "rope_shaping"


class RopeEnvState(NamedTuple):
    scene: SceneState
    target_yaw: jnp.ndarray  # [B] (shaping) / hanger offset [B, 2] packed below
    hanger_xy: jnp.ndarray  # [B, 2] randomized hanger position (closing)
    episode_step: jnp.ndarray
    key: jax.Array
    prev_action: jnp.ndarray


class RopeEnv:
    def __init__(self, cfg: RopeTaskCfg):
        self.cfg = cfg
        L = cfg.num_links

        self.body_spec = RigidBodySpec(
            inv_mass=jnp.asarray([1.0 / cfg.gripper_mass] * 2, jnp.float32),
            inv_inertia=jnp.tile(1.0 / box_inertia(cfg.gripper_mass, cfg.gripper_size), (2, 1)),
            gravity_scale=jnp.zeros(2),  # grippers: disable_gravity=True
            lin_damping=jnp.full((2,), 10.0),
            ang_damping=jnp.full((2,), 10.0),
            free_pos=jnp.tile(jnp.asarray([1.0, 1.0, 0.0]), (2, 1)),  # z locked
            free_rot=jnp.zeros((2, 3)),  # all rotation locked
        )
        self.particle_spec = ParticleSpec(
            inv_mass=jnp.full((L,), 1.0 / cfg.link_mass), lin_damping=cfg.rope_damping
        )
        # chain distance constraints in two conflict-free groups (even/odd)
        idx = np.arange(L - 1)
        even, odd = idx[idx % 2 == 0], idx[idx % 2 == 1]
        self.distance_groups = tuple(
            DistanceGroup(
                i=jnp.asarray(g, jnp.int32),
                j=jnp.asarray(g + 1, jnp.int32),
                rest=jnp.full((len(g),), cfg.link_spacing),
                compliance=jnp.zeros(len(g)),
            )
            for g in (even, odd)
        )
        self.attachments = BodyAttachment(
            particle=jnp.asarray([0, L - 1], jnp.int32),
            body=jnp.asarray([0, 1], jnp.int32),
            local_pos=jnp.zeros((2, 3)),
        )
        if cfg.is_shaping:
            if cfg.target_curve_file:
                curve = load_target_curve(cfg.target_curve_file, L, cfg.rope_length, cfg.rope_z)
                curve = curve - np.concatenate([curve[:, :2].mean(0), [0.0]]).astype(np.float32)
            else:
                curve = w_shape_curve(L, cfg.rope_length, cfg.rope_z)
            self.target_curve = jnp.asarray(curve)
        else:
            self.target_curve = None
        self.obs_spec = self._build_obs_spec()

    def _build_obs_spec(self) -> ObsSpec:
        L, G = self.cfg.num_links, 2
        return ObsSpec(
            names={
                "scalars": ["rope_target_distances"],
                "position_vectors": ["grippers", "links", "target_geometry"],
                "velocity_vectors": ["grippers", "links"],
                "infos": ["num_links"],
            },
            dims={
                "scalars": [1],
                "position_vectors": [3 * G, 3 * L, 3 * L],
                "velocity_vectors": [3 * G, 3 * L],
                "infos": [1],
            },
        )

    # ----------------------------------------------------------------- reset

    def _initial_layout(self, key: jax.Array):
        """Straight rope along +x, cubes at the ends, then the reset rotations
        (event_cfg.py Closing/ShapingRandomizationCfg).

        Closing reproduces the reference's two reset terms exactly
        (mdp/randomization.py:113-160, 177-280):
          1. yaw1 in +-pi/4 about the rope center, applied to cubes AND rope;
          2. yaw2 in +-pi about the DEFAULT hanger position, applied to the
             cubes from their term-1 poses but to the rope from its DEFAULT
             (straight) pose — the rope loses the term-1 rotation, so the
             welded cube offsets bend the rope during warmup (initial
             curvature diversity). The hanger itself is translated by
             U(+-0.5) in x/y, independent of the rotation origin.
        """
        cfg = self.cfg
        B, L = cfg.num_envs, cfg.num_links
        k1, k2, k3 = jax.random.split(key, 3)

        x = jnp.arange(L, dtype=jnp.float32) * cfg.link_spacing
        links = jnp.stack([x, jnp.zeros(L), jnp.full((L,), cfg.rope_z)], axis=-1)  # [L,3]
        links = jnp.broadcast_to(links, (B, L, 3))
        cubes = links[:, jnp.asarray([0, L - 1])]  # grippers at end links
        center = links.mean(axis=1, keepdims=True)

        if cfg.is_shaping:
            target_yaw = sample_uniform(k1, cfg.target_yaw_range[0], cfg.target_yaw_range[1], (B,))
            lo1, hi1 = cfg.shaping_rot_ranges[0]
            lo2, hi2 = cfg.shaping_rot_ranges[1]
            pick = jax.random.bernoulli(k2, shape=(B,))
            off = jnp.where(
                pick,
                sample_uniform(k3, lo2, hi2, (B,)),
                sample_uniform(k3, lo1, hi1, (B,)),
            )
            angle = target_yaw + off
            hanger_xy = jnp.zeros((B, 2))
            links = center + yaw_rotate_2d(links - center, angle)
            cubes = center + yaw_rotate_2d(cubes - center, angle)
        else:
            target_yaw = jnp.zeros((B,))
            # term 1: cubes + rope about rope center
            yaw1 = sample_uniform(k1, cfg.center_rot_range[0], cfg.center_rot_range[1], (B,))
            cubes = center + yaw_rotate_2d(cubes - center, yaw1)
            # term 2: about the DEFAULT hanger; rope restarts from default
            yaw2 = sample_uniform(k3, cfg.around_hanger_yaw[0], cfg.around_hanger_yaw[1], (B,))
            origin = jnp.broadcast_to(
                jnp.asarray([cfg.hanger_pos[0], cfg.hanger_pos[1], 0.0]), (B, 1, 3)
            )
            links = origin + yaw_rotate_2d(links - origin, yaw2)
            cubes = origin + yaw_rotate_2d(cubes - origin, yaw2)
            links = links.at[..., 2].set(cfg.rope_z)
            cubes = cubes.at[..., 2].set(cfg.rope_z)
            # hanger translation, independent of the rotation origin
            hanger_xy = jnp.asarray(cfg.hanger_pos[:2]) + sample_uniform(
                k2, -cfg.hanger_xy_range, cfg.hanger_xy_range, (B, 2)
            )

        scene = SceneState(
            bodies=RigidBodyState(
                pos=cubes,
                quat=jnp.broadcast_to(quat_identity(), (B, 2, 4)),
                lin_vel=jnp.zeros((B, 2, 3)),
                ang_vel=jnp.zeros((B, 2, 3)),
            ),
            particles=ParticleState(pos=links, vel=jnp.zeros((B, L, 3))),
        )
        return scene, target_yaw, hanger_xy

    def reset(self, key: jax.Array) -> RopeEnvState:
        cfg = self.cfg
        key, sub = jax.random.split(key)
        scene, target_yaw, hanger_xy = self._initial_layout(sub)
        # zero-action warmup after the explicit reset (OrbitTorchRLEnv._reset
        # semantics — auto-resets inside step get none, like RLTaskEnv)
        for _ in range(cfg.warmup_steps):
            zeroed = scene._replace(
                bodies=scene.bodies._replace(
                    lin_vel=scene.bodies.lin_vel * 0.0, ang_vel=scene.bodies.ang_vel * 0.0
                )
            )
            scene = self._physics(zeroed, hanger_xy)
        return RopeEnvState(
            scene=scene,
            target_yaw=target_yaw,
            hanger_xy=hanger_xy,
            episode_step=jnp.zeros((cfg.num_envs,), jnp.int32),
            key=key,
            prev_action=jnp.zeros((cfg.num_envs, cfg.action_dim)),
        )

    # ------------------------------------------------------------------ step

    def _particle_contacts(self, hanger_xy):
        cfg = self.cfg
        contacts = [
            ParticleSDFContact(
                sdf=lambda p: ground_sdf(p, cfg.ground_z), friction=0.3,
                restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.3,
            )
        ]
        if not cfg.is_shaping:
            radius = cfg.hanger_radius

            def pole_sdf(points):
                d_xy = points[..., :2] - hanger_xy[:, None, :]
                dist = jnp.linalg.norm(d_xy, axis=-1)
                phi = dist - radius
                n_xy = d_xy / jnp.maximum(dist, 1e-9)[..., None]
                n = jnp.concatenate([n_xy, jnp.zeros_like(points[..., :1])], axis=-1)
                return phi, n

            contacts.append(
                ParticleSDFContact(
                    sdf=pole_sdf, friction=0.4,
                    restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.4,
                )
            )
        return tuple(contacts)

    def _apply_action(self, scene: SceneState, action: jnp.ndarray) -> SceneState:
        cfg = self.cfg
        a = jnp.clip(action, -cfg.action_max, cfg.action_max)
        lin = scene.bodies.lin_vel
        for i in range(2):
            v = a[:, 3 * i : 3 * i + 3] * cfg.action_linear_scale
            v = v.at[:, 2].set(0.0)  # vel_command[:, 2] = 0 (actions.py:69)
            lin = lin.at[:, i].set(v)
        return scene._replace(bodies=scene.bodies._replace(lin_vel=lin))

    def _physics(self, scene: SceneState, hanger_xy) -> SceneState:
        cfg = self.cfg
        return step_physics(
            scene,
            self.body_spec,
            cfg.dt,
            cfg.decimation,
            particle_spec=self.particle_spec,
            distance_groups=self.distance_groups,
            attachments=self.attachments,
            particle_contacts=self._particle_contacts(hanger_xy),
            iterations=cfg.iterations,
        )

    def _target_points(self, state: RopeEnvState) -> jnp.ndarray:
        cfg = self.cfg
        B, L = cfg.num_envs, cfg.num_links
        if cfg.is_shaping:
            pts = jnp.broadcast_to(self.target_curve, (B, L, 3))
            return yaw_rotate_2d(pts, state.target_yaw)
        hanger = jnp.concatenate([state.hanger_xy, jnp.zeros((B, 1))], axis=-1)
        return jnp.broadcast_to(hanger[:, None, :], (B, L, 3))

    def _observe(self, state: RopeEnvState) -> Dict[str, jnp.ndarray]:
        cfg = self.cfg
        B = cfg.num_envs
        grip_pos = state.scene.bodies.pos.reshape(B, -1)
        grip_vel = state.scene.bodies.lin_vel.reshape(B, -1)
        links = state.scene.particles.pos.reshape(B, -1)
        links_vel = state.scene.particles.vel.reshape(B, -1)
        target = self._target_points(state).reshape(B, -1)
        return {
            "scalars": jnp.zeros((B, 1)),  # rope_target_distances_obs placeholder
            "position_vectors": jnp.concatenate([grip_pos, links, target], axis=-1),
            "velocity_vectors": jnp.concatenate([grip_vel, links_vel], axis=-1),
            "infos": jnp.full((B, 1), float(cfg.num_links)),
        }

    def _reward(self, state: RopeEnvState, action: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        links = state.scene.particles.pos  # [B,L,3]
        act_rate = jnp.sum((action - state.prev_action) ** 2, axis=-1)
        if cfg.is_shaping:
            target = self._target_points(state)
            cur_d = jax.vmap(shape_descriptor)(links[..., :2])
            tgt_d = jax.vmap(shape_descriptor)(target[..., :2])
            dist = jnp.mean((cur_d - tgt_d) ** 2, axis=-1)
            # weight applies when ALL envs are in the last steps (synchronized
            # episodes — mdp/rewards.py:213)
            in_last = state.episode_step >= cfg.episode_length - cfg.shaping_last_steps
            dist = jnp.where(in_last, dist * cfg.shaping_weight_last, dist)
            return cfg.shaping_weight * dist + cfg.shaping_action_rate_weight * act_rate
        # closing
        grip = state.scene.bodies.pos
        grip_dist = jnp.linalg.norm(grip[:, 0, :2] - grip[:, 1, :2], axis=-1)
        in_last = state.episode_step >= cfg.episode_length - cfg.closing_grip_last_steps
        grip_term = jnp.where(in_last, grip_dist, 0.0)
        centroid = links[..., :2].mean(axis=1)
        wrap = jnp.linalg.norm(state.hanger_xy - centroid, axis=-1)
        vel = jnp.linalg.norm(state.scene.particles.vel, axis=-1).mean(axis=-1)
        return (
            cfg.closing_grip_weight * grip_term
            + cfg.closing_wrap_weight * wrap
            + cfg.closing_vel_weight * vel
            + cfg.closing_action_rate_weight * act_rate
        )

    @partial(jax.jit, static_argnums=0)
    def step(self, state: RopeEnvState, action: jnp.ndarray) -> Tuple[RopeEnvState, TimeStep]:
        cfg = self.cfg
        scene = self._apply_action(state.scene, action)
        scene = self._physics(scene, state.hanger_xy)
        stepped = state._replace(scene=scene, episode_step=state.episode_step + 1)

        reward = self._reward(stepped, action)
        done = stepped.episode_step >= cfg.episode_length

        key, sub = jax.random.split(stepped.key)
        fresh_scene, fresh_yaw, fresh_hxy = self._initial_layout(sub)
        d1, d2, d3 = done[:, None], done[:, None, None], done[:, None, None]
        new_scene = SceneState(
            bodies=RigidBodyState(
                pos=jnp.where(d3, fresh_scene.bodies.pos, scene.bodies.pos),
                quat=jnp.where(d3, fresh_scene.bodies.quat, scene.bodies.quat),
                lin_vel=jnp.where(d3, fresh_scene.bodies.lin_vel, scene.bodies.lin_vel),
                ang_vel=jnp.where(d3, fresh_scene.bodies.ang_vel, scene.bodies.ang_vel),
            ),
            particles=ParticleState(
                pos=jnp.where(d3, fresh_scene.particles.pos, scene.particles.pos),
                vel=jnp.where(d3, fresh_scene.particles.vel, scene.particles.vel),
            ),
        )
        new_state = RopeEnvState(
            scene=new_scene,
            target_yaw=jnp.where(done, fresh_yaw, stepped.target_yaw),
            hanger_xy=jnp.where(d1, fresh_hxy, stepped.hanger_xy),
            episode_step=jnp.where(done, 0, stepped.episode_step),
            key=key,
            prev_action=jnp.where(d1, 0.0, action),
        )
        obs = self._observe(new_state)
        # success metric (pre-reset state): closing -> gripper-gripper planar
        # gap; shaping -> RMS shape-descriptor error vs the target curve
        if cfg.is_shaping:
            target = self._target_points(stepped)
            cur_d = jax.vmap(shape_descriptor)(stepped.scene.particles.pos[..., :2])
            tgt_d = jax.vmap(shape_descriptor)(target[..., :2])
            task_dist = jnp.sqrt(jnp.mean((cur_d - tgt_d) ** 2, axis=-1))
        else:
            grip = stepped.scene.bodies.pos
            task_dist = jnp.linalg.norm(grip[:, 0, :2] - grip[:, 1, :2], axis=-1)
        return new_state, TimeStep(
            obs=obs,
            reward=reward,
            done=done,
            info={"episode_step": new_state.episode_step, "object_target_distance": task_dist},
        )

    @partial(jax.jit, static_argnums=0)
    def observe(self, state: RopeEnvState) -> Dict[str, jnp.ndarray]:
        return self._observe(state)


def rope_closing_cfg(num_envs: int = 40, **kw) -> RopeTaskCfg:
    kw.setdefault("num_links", 40)
    kw.setdefault("rope_length", 5.0)
    return RopeTaskCfg(name="rope_closing", num_envs=num_envs, **kw)


def rope_shaping_cfg(num_envs: int = 40, **kw) -> RopeTaskCfg:
    kw.setdefault("num_links", 80)
    kw.setdefault("rope_length", 10.0)
    return RopeTaskCfg(name="rope_shaping", num_envs=num_envs, **kw)
