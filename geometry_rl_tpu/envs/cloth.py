"""Cloth hanging task: hang a holed cloth onto a hook.

JAX redesign of `geometry_rl/orbit/tasks/manipulation/cloth_tasks/`: the PhysX
15x15 particle cloth with a procedurally-placed hole
(SquareClothWithHoles, scene_cfg.py:33-45,154-177) becomes an XPBD particle
grid with stretch / shear / bend distance-constraint groups whose compliances
map from the PhysX spring stiffnesses (stretch 2e6, shear 100, bend 1 ->
compliance ~= 1/k). The hole is a per-env constraint/particle mask over a
static grid: 20 train placements sampled around the center (split_combinations
seed semantics), round-robin over envs — the multi-asset mechanism.

Scene: 4 gripper cubes attached to the cloth corners (BodyAttachmentCfg),
a hook (horizontal cylinder along +y, cylinder.usd scale 0.2) the cloth's hole
must be hung onto. Episode 100 steps (2 s, decimation 2).

Rewards (ICLRHangingRewardsCfg): -0.8 * (hole-centroid -> hanger distance +
0.1 * orientation, x5 in last 2 steps) - 0.2 * mean particle speed
- 1.0 * edge distortion - 2e-3 * action rate.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sim.types import ClothSolveSpec, ParticleState, RigidBodySpec, RigidBodyState, SceneState, box_inertia
from ..sim.xpbd import (
    BodyAttachment,
    DistanceGroup,
    ParticleSDFContact,
    ParticleSelfContact,
    ParticleSpec,
    step_physics,
)
from ..utils.math import quat_apply, quat_from_euler_xyz, quat_identity, quat_mul, sample_uniform
from .base import ObsSpec, TimeStep

N_ROW = 15  # num_particles_per_row (scene_cfg.py:33)
N_PARTICLES = N_ROW * N_ROW
K_BOUNDARY = 10  # KDTree-closest boundary nodes (tasks/common/utils.py:72-147)


def grid_index(r: int, c: int) -> int:
    return r * N_ROW + c


def sample_hole_placements(num_holes: int = 40, max_offset: int = 3, seed: int = 2):
    """Hole-center placements around the cloth center (scene_cfg.py:154-176):
    integer grid offsets within +-3, deduplicated, deterministic order."""
    import random as _random

    rng = _random.Random(seed)
    center = N_ROW // 2
    combos = set()
    while len(combos) < num_holes:
        x = rng.randint(center - max_offset, center + max_offset)
        y = rng.randint(center - max_offset, center + max_offset)
        combos.add((x, y))
    return list(combos)


def build_hole_variant(hole_rc: Tuple[int, int], radius_grid: float = 1.1):
    """For one hole placement: (removed-particle mask [P], boundary indices
    [K_BOUNDARY]). Vertices within `radius_grid` grid units of the hole center
    are removed; the boundary is the K closest remaining vertices."""
    hr, hc = hole_rc
    rows, cols = np.meshgrid(np.arange(N_ROW), np.arange(N_ROW), indexing="ij")
    d = np.sqrt((rows - hr) ** 2 + (cols - hc) ** 2).reshape(-1)
    removed = d <= radius_grid
    order = np.argsort(np.where(removed, np.inf, d))
    boundary = order[:K_BOUNDARY]
    return removed.astype(np.float32), boundary.astype(np.int32)


def grid_constraints():
    """Grid distance-constraint index lists by family with conflict-free
    groups: stretch (axis edges), shear (diagonals), bend (skip-one)."""

    def pairs(dr, dc):
        out = []
        for r in range(N_ROW):
            for c in range(N_ROW):
                r2, c2 = r + dr, c + dc
                if 0 <= r2 < N_ROW and 0 <= c2 < N_ROW:
                    out.append((grid_index(r, c), grid_index(r2, c2)))
        return np.asarray(out, np.int64)

    # conflict-free split: alternate on the marching coordinate
    def split(p, axis_vals, step):
        even = p[axis_vals % (2 * step) < step]
        odd = p[axis_vals % (2 * step) >= step]
        return [even, odd]

    groups = []
    # stretch: horizontal (dr=0,dc=1) split by c%2; vertical split by r%2
    p = pairs(0, 1)
    groups += [("stretch", g) for g in split(p, (p[:, 0] % N_ROW), 1)]
    p = pairs(1, 0)
    groups += [("stretch", g) for g in split(p, (p[:, 0] // N_ROW), 1)]
    # shear: two diagonal directions, split by row parity
    for dr, dc in ((1, 1), (1, -1)):
        p = pairs(dr, dc)
        groups += [("shear", g) for g in split(p, (p[:, 0] // N_ROW), 1)]
    # bend: skip-one along each axis, split by (coord // 1) % 2 over stride 2
    p = pairs(0, 2)
    groups += [("bend", g) for g in split(p, (p[:, 0] % N_ROW), 2)]
    p = pairs(2, 0)
    groups += [("bend", g) for g in split(p, (p[:, 0] // N_ROW), 2)]
    return groups


@dataclasses.dataclass(frozen=True)
class ClothTaskCfg:
    name: str = "cloth_hanging"
    num_envs: int = 40
    num_holes: int = 20  # TRAIN_SIZE placements (scene_cfg.py:172)
    hole_split: str = "train"  # train | test (scene_cfg.py split_combinations)
    # fused position-solve kernel (sim/pallas_cloth.py): True = kernel,
    # False = XLA solver, "auto" = kernel on a GPU unless self-collision or
    # the velocity-pass material is on, XLA elsewhere
    use_pallas_solver: object = "auto"
    episode_length: int = 100
    decimation: int = 2
    dt: float = 0.01
    iterations: int = 10
    warmup_steps: int = 10  # cloth_hanging cfg warmup_steps: 10

    cloth_size: float = 1.0  # 1m x 1m (gripper corner spacing)
    cloth_mass: float = 0.05
    cloth_damping: float = 1.0
    # XPBD compliances ~ 1/stiffness (ClothPropertiesCfg stretch 2e6,
    # shear 100, bend 1 — scene_cfg.py:110-116)
    stretch_compliance: float = 5e-7
    shear_compliance: float = 1e-2
    bend_compliance: float = 1.0
    # PhysX particle-cloth self-collision (particle_contact_offset,
    # scene_cfg.py:43-45 restOffset = 0.5/(N+1), separation = 2*restOffset).
    # Off by default: enables the dense all-pairs pass of the XLA solver
    # (the fused kernel has none, so "auto" then picks the XLA solver).
    self_collision: bool = False
    self_collision_distance: Optional[float] = None  # default 2*restOffset
    # velocity-pass material on the hook contact (RigidBodyMaterialCfg()
    # defaults: dynamic == static friction, restitution 0). The velocity pass
    # lives in the XLA solver only; enabling it steers "auto" to the XLA path
    # and rejects an explicitly requested kernel.
    restitution: float = 0.0
    dynamic_friction_scale: float = 0.0

    gripper_mass: float = 10.0
    gripper_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)

    cloth_center: Tuple[float, float, float] = (0.0, 0.0, 4.5)
    hanger_pos: Tuple[float, float, float] = (0.0, -1.5, 4.5)
    hanger_radius: float = 0.08
    hanger_half_len: float = 0.5
    hanger_xz_range: float = 0.5  # origin_position_range x/z (event_cfg.py)
    # rotate-around-hanger angle ranges (event_cfg.py:41-45)
    roll_range: Tuple[float, float] = (-math.pi / 4, math.pi / 2)
    pitch_range: Tuple[float, float] = (-math.pi / 2, math.pi / 2)
    yaw_range: Tuple[float, float] = (-math.pi, math.pi)
    spin_range: Tuple[float, float] = (-math.pi, math.pi)  # about-y cloth spin

    # rewards (ICLRHangingRewardsCfg)
    tracking_weight: float = -0.8
    distortion_area_based: bool = False  # HangingRewardsCfg variant (edge = ICLR)
    n_last_steps: int = 2
    weight_n_last_steps: float = 5.0
    orientation_weight: float = 0.1
    velocity_weight: float = -0.2
    distortion_weight: float = -1.0
    action_rate_weight: float = -2e-3

    action_max: float = 1.0
    # cloth CubeActionTerm: clamp(+-1) * 2.0, z allowed (cloth_tasks/mdp/
    # actions.py:32-36 action_scale=2.0, action_dim=3)
    action_scale: float = 2.0

    @property
    def num_grippers(self) -> int:
        return 4

    @property
    def action_dim(self) -> int:
        return 3 * self.num_grippers  # cloth_tasks/mdp/actions.py:40-41 (3D)

    @property
    def spacing(self) -> float:
        return self.cloth_size / (N_ROW - 1)


class ClothEnvState(NamedTuple):
    scene: SceneState
    hanger_pos: jnp.ndarray  # [B, 3]
    episode_step: jnp.ndarray
    key: jax.Array
    prev_action: jnp.ndarray


class ClothEnv:
    def __init__(self, cfg: ClothTaskCfg):
        self.cfg = cfg
        B = cfg.num_envs

        # --- hole variants (multi-asset round-robin; TRAIN first 20 of the 40
        # seeded placements, TEST the next 20 — scene_cfg.py:161-177) --------
        all_placements = sample_hole_placements()
        if cfg.hole_split == "train":
            placements = all_placements[: cfg.num_holes]
        elif cfg.hole_split == "test":
            placements = all_placements[20 : 20 + cfg.num_holes]
        else:
            raise ValueError(f"hole_split must be train|test, got {cfg.hole_split!r}")
        removed, boundary = zip(*(build_hole_variant(p) for p in placements))
        removed = np.stack(removed)  # [V, P]
        boundary = np.stack(boundary)  # [V, K]
        variant_ids = np.arange(B) % cfg.num_holes
        self.hole_mask = jnp.asarray(removed[variant_ids])  # [B, P] 1 = removed
        self.boundary_idx = jnp.asarray(boundary[variant_ids])  # [B, K]

        # --- local cloth layout (vertical sheet in the xz plane) -----------
        s = cfg.spacing
        r, c = np.meshgrid(np.arange(N_ROW), np.arange(N_ROW), indexing="ij")
        x = (c - (N_ROW - 1) / 2) * s
        z = ((N_ROW - 1) / 2 - r) * s
        local = np.stack([x, np.zeros_like(x), z], axis=-1).reshape(-1, 3).astype(np.float32)
        self.local_particles = jnp.asarray(local)  # [P, 3] about the cloth center
        self.corner_indices = jnp.asarray(
            [
                grid_index(0, 0),
                grid_index(0, N_ROW - 1),
                grid_index(N_ROW - 1, 0),
                grid_index(N_ROW - 1, N_ROW - 1),
            ],
            jnp.int32,
        )

        # --- constraints ----------------------------------------------------
        compliance_of = {
            "stretch": cfg.stretch_compliance,
            "shear": cfg.shear_compliance,
            "bend": cfg.bend_compliance,
        }
        groups = []
        edge_list = []  # stretch+shear edges for obs/distortion
        for family, pairs in grid_constraints():
            i, j = pairs[:, 0], pairs[:, 1]
            rest = np.linalg.norm(local[i] - local[j], axis=-1).astype(np.float32)
            # constraint disabled if either endpoint is removed (per env)
            valid = (1.0 - removed[variant_ids][:, i]) * (1.0 - removed[variant_ids][:, j])
            groups.append(
                DistanceGroup(
                    i=jnp.asarray(i, jnp.int32),
                    j=jnp.asarray(j, jnp.int32),
                    rest=jnp.asarray(rest),
                    compliance=jnp.full((len(i),), compliance_of[family]),
                    mask=jnp.asarray(valid),
                )
            )
            if family in ("stretch", "shear"):
                edge_list.append((pairs, valid))
        self.distance_groups = tuple(groups)

        # triangles for the area-based distortion variant (two per grid quad)
        tris = []
        for r in range(N_ROW - 1):
            for c in range(N_ROW - 1):
                a, b_, c_, d_ = (
                    grid_index(r, c),
                    grid_index(r, c + 1),
                    grid_index(r + 1, c),
                    grid_index(r + 1, c + 1),
                )
                tris.append((a, b_, c_))
                tris.append((b_, d_, c_))
        tris = np.asarray(tris, np.int64)
        tri_valid = (
            (1.0 - removed[variant_ids][:, tris[:, 0]])
            * (1.0 - removed[variant_ids][:, tris[:, 1]])
            * (1.0 - removed[variant_ids][:, tris[:, 2]])
        )
        self.triangles = jnp.asarray(tris, jnp.int32)
        self.tri_mask = jnp.asarray(tri_valid)
        tri_rest = 0.5 * np.linalg.norm(
            np.cross(local[tris[:, 1]] - local[tris[:, 0]], local[tris[:, 2]] - local[tris[:, 0]]),
            axis=-1,
        )
        self.tri_rest_area = jnp.asarray(tri_rest.astype(np.float32))

        # static obs edge set (mesh edges, cloth_edges obs term + distortion)
        all_edges = np.concatenate([e for e, _ in edge_list], axis=0)  # [E,2]
        all_valid = np.concatenate([v for _, v in edge_list], axis=1)  # [B,E]
        self.obs_edges = jnp.asarray(all_edges, jnp.int32)
        self.obs_edge_mask = jnp.asarray(all_valid)
        rest_all = np.linalg.norm(local[all_edges[:, 0]] - local[all_edges[:, 1]], axis=-1)
        self.obs_edge_rest = jnp.asarray(rest_all.astype(np.float32))

        # --- bodies (4 gripper cubes) ---------------------------------------
        G = cfg.num_grippers
        self.body_spec = RigidBodySpec(
            inv_mass=jnp.full((G,), 1.0 / cfg.gripper_mass),
            inv_inertia=jnp.tile(1.0 / box_inertia(cfg.gripper_mass, cfg.gripper_size), (G, 1)),
            gravity_scale=jnp.zeros(G),
            lin_damping=jnp.full((G,), 10.0),
            ang_damping=jnp.full((G,), 10.0),
            free_pos=jnp.ones((G, 3)),
            free_rot=jnp.zeros((G, 3)),  # locked_rot_axis=7
        )
        # particle masses: removed particles get inv_mass 0 AND are pinned by
        # having no constraints; mass per particle = total / count
        inv_m = N_PARTICLES / cfg.cloth_mass
        self.particle_spec = ParticleSpec(
            inv_mass=jnp.where(self.hole_mask > 0.5, 0.0, inv_m), lin_damping=cfg.cloth_damping
        )
        self.attachments = BodyAttachment(
            particle=self.corner_indices,
            body=jnp.arange(G, dtype=jnp.int32),
            local_pos=jnp.zeros((G, 3)),
        )

        # --- self-collision (optional; PhysX particle_contact_offset) -------
        self.self_contacts: Tuple[ParticleSelfContact, ...] = ()
        if cfg.self_collision:
            rr, cc = np.divmod(np.arange(N_PARTICLES), N_ROW)
            cheb = np.maximum(
                np.abs(rr[:, None] - rr[None, :]), np.abs(cc[:, None] - cc[None, :])
            )
            # exclude self + the 8-neighborhood (held apart by stretch/shear)
            pair_mask = (cheb > 1).astype(np.float32)
            min_dist = cfg.self_collision_distance
            if min_dist is None:
                min_dist = cfg.cloth_size / (N_ROW + 1)  # 2 * restOffset
            self.self_contacts = (
                ParticleSelfContact(
                    min_dist=float(min_dist),
                    pair_mask=jnp.asarray(pair_mask),
                    active=1.0 - self.hole_mask,
                ),
            )

        self.obs_spec = self._build_obs_spec()

        # --- fused position-solve kernel (optional) -------------------------
        self.solve_spec = ClothSolveSpec(
            group_compliance=tuple(float(np.asarray(g.compliance)[0]) for g in self.distance_groups),
            num_particles=N_PARTICLES,
            num_bodies=G,
            iterations=cfg.iterations,
            dt=cfg.dt,
            hook_radius=cfg.hanger_radius,
            hook_half_len=cfg.hanger_half_len,
            hook_friction=0.2,
        )
        self.solver_mode = self._choose_solver(cfg)

    @staticmethod
    def _choose_solver(cfg: ClothTaskCfg) -> bool:
        """True = fused kernel, False = XLA solver."""
        unsupported = []
        if cfg.restitution > 0.0 or cfg.dynamic_friction_scale > 0.0:
            unsupported.append("the velocity-pass material (restitution/dynamic_friction_scale)")
        if cfg.self_collision:
            unsupported.append("self_collision")
        if cfg.use_pallas_solver == "auto":
            return jax.default_backend() == "gpu" and not unsupported
        if cfg.use_pallas_solver and unsupported:
            raise ValueError(
                f"use_pallas_solver=true is incompatible with {' and '.join(unsupported)}: "
                "the kernel implements the position solve only. Use "
                "use_pallas_solver=false (or 'auto')."
            )
        return bool(cfg.use_pallas_solver)

    def _build_obs_spec(self) -> ObsSpec:
        E = self.obs_edges.shape[0]
        G, P, K = self.cfg.num_grippers, N_PARTICLES, K_BOUNDARY
        return ObsSpec(
            names={
                "scalars": ["hole_target_distances", "cloth_edges_length"],
                "position_vectors": ["grippers", "particles", "init_particles", "hole_boundary", "target_hook"],
                "velocity_vectors": ["grippers", "particles"],
                "infos": ["hole_boundary_indices"],
            },
            dims={
                "scalars": [K, 2 * E],
                "position_vectors": [3 * G, 3 * P, 3 * P, 3 * K, 3],
                "velocity_vectors": [3 * G, 3 * P],
                "infos": [K],
            },
        )

    # ----------------------------------------------------------------- reset

    def _initial_layout(self, key: jax.Array):
        cfg = self.cfg
        B, P, G = cfg.num_envs, N_PARTICLES, cfg.num_grippers
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)

        hanger = jnp.asarray(cfg.hanger_pos) + jnp.stack(
            [
                sample_uniform(k1, -cfg.hanger_xz_range, cfg.hanger_xz_range, (B,)),
                jnp.zeros(B),
                sample_uniform(k2, -cfg.hanger_xz_range, cfg.hanger_xz_range, (B,)),
            ],
            axis=-1,
        )

        center = jnp.asarray(cfg.cloth_center)
        particles = center + self.local_particles[None]  # [B?, P, 3] broadcast
        particles = jnp.broadcast_to(particles, (B, P, 3))
        cubes = particles[:, self.corner_indices]  # [B, G, 3]

        # spin the cloth in its own plane about the y axis through its center
        # (reset_cubes_uniform_rotation_around_y, rigid_tasks/mdp/randomization.py:49-83)
        spin = sample_uniform(k3, cfg.spin_range[0], cfg.spin_range[1], (B,))
        q_spin = quat_from_euler_xyz(jnp.zeros(B), spin, jnp.zeros(B))
        particles = center + quat_apply(q_spin[:, None, :], particles - center)
        cubes = center + quat_apply(q_spin[:, None, :], cubes - center)

        # rotate cloth+cubes around the hanger (reset_cubes_uniform_around_origin)
        kr, kp, ky = jax.random.split(k4, 3)
        roll = sample_uniform(kr, cfg.roll_range[0], cfg.roll_range[1], (B,))
        pitch = sample_uniform(kp, cfg.pitch_range[0], cfg.pitch_range[1], (B,))
        yaw = sample_uniform(ky, cfg.yaw_range[0], cfg.yaw_range[1], (B,))
        q = quat_from_euler_xyz(roll, pitch, yaw)
        particles = hanger[:, None] + quat_apply(q[:, None, :], particles - hanger[:, None])
        cubes = hanger[:, None] + quat_apply(q[:, None, :], cubes - hanger[:, None])

        scene = SceneState(
            bodies=RigidBodyState(
                pos=cubes,
                quat=jnp.broadcast_to(quat_identity(), (B, 4, 4)),
                lin_vel=jnp.zeros((B, 4, 3)),
                ang_vel=jnp.zeros((B, 4, 3)),
            ),
            particles=ParticleState(pos=particles, vel=jnp.zeros((B, P, 3))),
        )
        return scene, hanger

    def reset(self, key: jax.Array) -> ClothEnvState:
        cfg = self.cfg
        key, sub = jax.random.split(key)
        scene, hanger = self._initial_layout(sub)
        state = ClothEnvState(
            scene=scene,
            hanger_pos=hanger,
            episode_step=jnp.zeros((cfg.num_envs,), jnp.int32),
            key=key,
            prev_action=jnp.zeros((cfg.num_envs, cfg.action_dim)),
        )
        for _ in range(cfg.warmup_steps):
            zero_vel = scene.bodies.lin_vel * 0.0
            scene = state.scene._replace(
                bodies=state.scene.bodies._replace(lin_vel=zero_vel, ang_vel=zero_vel)
            )
            state = state._replace(scene=self._physics(scene, state.hanger_pos))
        return state

    # ------------------------------------------------------------------ step

    def _hanger_contacts(self, hanger_pos):
        cfg = self.cfg

        def hook_sdf(points):
            """Capsule along +y from the hanger origin (cylinder.usd rotated
            90deg about x — scene_cfg.py:55-79)."""
            rel = points - hanger_pos[:, None, :]
            y = jnp.clip(rel[..., 1], 0.0, 2 * cfg.hanger_half_len)
            closest = jnp.stack([jnp.zeros_like(y), y, jnp.zeros_like(y)], axis=-1)
            d = rel - closest
            dist = jnp.linalg.norm(d, axis=-1)
            phi = dist - cfg.hanger_radius
            n = d / jnp.maximum(dist, 1e-9)[..., None]
            return phi, n

        return (
            ParticleSDFContact(
                sdf=hook_sdf, friction=0.2,
                restitution=cfg.restitution, dynamic_friction=cfg.dynamic_friction_scale * 0.2,
            ),
        )

    def _apply_action(self, scene: SceneState, action: jnp.ndarray) -> SceneState:
        cfg = self.cfg
        a = jnp.clip(action, -cfg.action_max, cfg.action_max)
        lin = scene.bodies.lin_vel
        for i in range(cfg.num_grippers):
            v = a[:, 3 * i : 3 * i + 3] * cfg.action_scale
            lin = lin.at[:, i].set(v)  # z allowed (3D hanging task)
        return scene._replace(bodies=scene.bodies._replace(lin_vel=lin))

    def _physics(self, scene: SceneState, hanger_pos) -> SceneState:
        cfg = self.cfg
        if self.solver_mode:
            return self._physics_pallas(scene, hanger_pos)
        return step_physics(
            scene,
            self.body_spec,
            cfg.dt,
            cfg.decimation,
            particle_spec=self.particle_spec,
            distance_groups=self.distance_groups,
            attachments=self.attachments,
            particle_contacts=self._hanger_contacts(hanger_pos),
            self_contacts=self.self_contacts,
            iterations=cfg.iterations,
        )

    def _physics_pallas(self, scene: SceneState, hanger_pos, interpret: bool = False) -> SceneState:
        """Decimation substeps with the fused position-solve kernel.

        Cloth cubes have rotation fully locked and attach at their center of
        mass, so their rigid dynamics reduce exactly to point-particle
        dynamics: they are appended as pseudo-particles and the whole solve
        runs in one kernel launch per substep. `interpret` runs the kernel on
        the CPU (tests only)."""
        from ..sim.pallas_cloth import cloth_position_solve, pack_groups

        groups = pack_groups(self.distance_groups, N_PARTICLES + self.cfg.num_grippers)
        cfg = self.cfg
        B, G = cfg.num_envs, cfg.num_grippers
        dt = cfg.dt
        from ..sim.xpbd import GRAVITY

        body_lin_damp = jnp.exp(-self.body_spec.lin_damping * dt)  # [G]
        part_damp = jnp.exp(-self.particle_spec.lin_damping * dt)
        inv_all = jnp.concatenate(
            [self.particle_spec.inv_mass, jnp.broadcast_to(self.body_spec.inv_mass[None], (B, G))], axis=1
        )
        att_body_w = jnp.broadcast_to(self.body_spec.inv_mass[None], (B, G))

        def substep(scene, _):
            bodies, parts = scene.bodies, scene.particles
            # integrate (matches xpbd_substep: grippers gravity_scale 0)
            v_b = bodies.lin_vel * body_lin_damp[:, None]
            prev_b = bodies.pos
            pos_b = bodies.pos + dt * v_b

            pv = (parts.vel + dt * GRAVITY * (self.particle_spec.inv_mass > 0)[..., None]) * part_damp
            prev_p = parts.pos
            x_p = parts.pos + dt * pv

            x = jnp.concatenate([x_p, pos_b], axis=1)
            prev_x = jnp.concatenate([prev_p, prev_b], axis=1)
            x = cloth_position_solve(
                self.solve_spec,
                x,
                prev_x,
                inv_all,
                hanger_pos,
                att_body_w,
                self.corner_indices,
                groups,
                interpret=interpret,
            )
            new_p, new_b = x[:, : x_p.shape[1]], x[:, x_p.shape[1] :]

            new_scene = SceneState(
                bodies=bodies._replace(
                    pos=new_b,
                    lin_vel=(new_b - prev_b) / dt,
                    ang_vel=jnp.zeros_like(bodies.ang_vel),
                ),
                particles=ParticleState(pos=new_p, vel=(new_p - prev_p) / dt),
            )
            return new_scene, None

        scene, _ = jax.lax.scan(substep, scene, None, length=cfg.decimation)
        return scene

    # ------------------------------------------------------------- obs/reward

    def _hole_centroid(self, particles: jnp.ndarray) -> jnp.ndarray:
        """Mean of the K boundary nodes (mdp/rewards.py compute_centroids)."""
        idx = self.boundary_idx  # [B, K]
        pts = jnp.take_along_axis(particles, idx[..., None], axis=1)
        return pts.mean(axis=1)

    def _edge_lengths(self, particles: jnp.ndarray) -> jnp.ndarray:
        e = self.obs_edges
        return jnp.linalg.norm(
            particles[:, e[:, 0]] - particles[:, e[:, 1]], axis=-1
        )  # [B, E]

    def _observe(self, state: ClothEnvState) -> Dict[str, jnp.ndarray]:
        cfg = self.cfg
        B = cfg.num_envs
        parts = state.scene.particles.pos
        boundary = jnp.take_along_axis(parts, self.boundary_idx[..., None], axis=1)  # [B,K,3]
        hanger = state.hanger_pos

        hole_dists = jnp.linalg.norm(boundary - hanger[:, None], axis=-1)  # [B,K]
        edges_flat = jnp.broadcast_to(
            self.obs_edges.reshape(-1).astype(jnp.float32), (B, 2 * self.obs_edges.shape[0])
        )
        init_parts = jnp.broadcast_to(
            (jnp.asarray(cfg.cloth_center) + self.local_particles), (B, N_PARTICLES, 3)
        )
        return {
            "scalars": jnp.concatenate([hole_dists, edges_flat], axis=-1),
            "position_vectors": jnp.concatenate(
                [
                    state.scene.bodies.pos.reshape(B, -1),
                    parts.reshape(B, -1),
                    init_parts.reshape(B, -1),
                    boundary.reshape(B, -1),
                    hanger,
                ],
                axis=-1,
            ),
            "velocity_vectors": jnp.concatenate(
                [state.scene.bodies.lin_vel.reshape(B, -1), state.scene.particles.vel.reshape(B, -1)],
                axis=-1,
            ),
            "infos": self.boundary_idx.astype(jnp.float32),
        }

    def _reward(self, state: ClothEnvState, action: jnp.ndarray) -> jnp.ndarray:
        cfg = self.cfg
        parts = state.scene.particles.pos
        centroid = self._hole_centroid(parts)
        dvec = centroid - state.hanger_pos
        distance = jnp.linalg.norm(dvec, axis=-1)
        # orientation: hole should sit on the +y side of the hook
        # (local_forward (0,1,0), mdp/rewards.py:84-89)
        unit = dvec / jnp.maximum(distance, 1e-9)[..., None]
        ori = jnp.abs(unit[..., 1] - 1.0)

        in_last = state.episode_step >= cfg.episode_length - cfg.n_last_steps
        w = jnp.where(in_last, cfg.weight_n_last_steps, 1.0)
        tracking = w * distance + cfg.orientation_weight * (w * ori)

        vel = jnp.linalg.norm(state.scene.particles.vel, axis=-1).mean(axis=-1)

        if cfg.distortion_area_based:
            # triangle-area deviation (mdp/rewards.py points_distortion area_based)
            t = self.triangles
            v1 = parts[:, t[:, 1]] - parts[:, t[:, 0]]
            v2 = parts[:, t[:, 2]] - parts[:, t[:, 0]]
            areas = 0.5 * jnp.linalg.norm(jnp.cross(v1, v2), axis=-1)
            deviation = jnp.abs((areas - self.tri_rest_area) / self.tri_rest_area)
            distortion = (deviation * self.tri_mask).sum(-1) / jnp.maximum(self.tri_mask.sum(-1), 1.0)
        else:
            lengths = self._edge_lengths(parts)
            deviation = jnp.abs((lengths - self.obs_edge_rest) / self.obs_edge_rest)
            distortion = (deviation * self.obs_edge_mask).sum(-1) / jnp.maximum(self.obs_edge_mask.sum(-1), 1.0)

        act_rate = jnp.sum((action - state.prev_action) ** 2, axis=-1)
        return (
            cfg.tracking_weight * tracking
            + cfg.velocity_weight * vel
            + cfg.distortion_weight * distortion
            + cfg.action_rate_weight * act_rate
        )

    @partial(jax.jit, static_argnums=0)
    def step(self, state: ClothEnvState, action: jnp.ndarray) -> Tuple[ClothEnvState, TimeStep]:
        cfg = self.cfg
        scene = self._apply_action(state.scene, action)
        scene = self._physics(scene, state.hanger_pos)
        stepped = state._replace(scene=scene, episode_step=state.episode_step + 1)

        reward = self._reward(stepped, action)
        done = stepped.episode_step >= cfg.episode_length

        key, sub = jax.random.split(stepped.key)
        fresh, fresh_hanger = self._initial_layout(sub)
        d1, d3 = done[:, None], done[:, None, None]
        new_scene = SceneState(
            bodies=RigidBodyState(
                pos=jnp.where(d3, fresh.bodies.pos, scene.bodies.pos),
                quat=jnp.where(d3, fresh.bodies.quat, scene.bodies.quat),
                lin_vel=jnp.where(d3, fresh.bodies.lin_vel, scene.bodies.lin_vel),
                ang_vel=jnp.where(d3, fresh.bodies.ang_vel, scene.bodies.ang_vel),
            ),
            particles=ParticleState(
                pos=jnp.where(d3, fresh.particles.pos, scene.particles.pos),
                vel=jnp.where(d3, fresh.particles.vel, scene.particles.vel),
            ),
        )
        new_state = ClothEnvState(
            scene=new_scene,
            hanger_pos=jnp.where(d1, fresh_hanger, stepped.hanger_pos),
            episode_step=jnp.where(done, 0, stepped.episode_step),
            key=key,
            prev_action=jnp.where(d1, 0.0, action),
        )
        obs = self._observe(new_state)
        # success metric: hole centroid -> hook distance at this step (pre-reset
        # state), consumed by Trainer.eval_success / scripts/eval_breakdown.py
        hole_dist = jnp.linalg.norm(
            self._hole_centroid(stepped.scene.particles.pos) - stepped.hanger_pos, axis=-1
        )
        return new_state, TimeStep(
            obs=obs,
            reward=reward,
            done=done,
            info={"episode_step": new_state.episode_step, "object_target_distance": hole_dist},
        )

    @partial(jax.jit, static_argnums=0)
    def observe(self, state: ClothEnvState) -> Dict[str, jnp.ndarray]:
        return self._observe(state)


def cloth_hanging_cfg(num_envs: int = 40, **kw) -> ClothTaskCfg:
    return ClothTaskCfg(name="cloth_hanging", num_envs=num_envs, **kw)
