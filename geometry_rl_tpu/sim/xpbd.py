"""Batched XPBD solver — rigid bodies, particles, joints, contacts.

One unified position-based dynamics core replaces PhysX for every reference
task (SURVEY.md §2.10): rigid assemblies (peg + suction gripper welded by
fixed joints, driven by root-velocity commands), XPBD particle systems (cloth,
rope), attachments (particle<->body), and point-vs-SDF contact with Coulomb
friction. Everything is a pure function of (state, specs) with static shapes:
`vmap` over envs, `lax.scan` over substeps, sharded over the device mesh.

Solver scheme per substep (Müller et al., "Detailed Rigid Body Simulation
with XPBD", 2020):
  1. integrate velocities (gravity, damping, axis locks) and positions
  2. Jacobi-iterate positional constraints: fixed joints (point + relative
     orientation), point-vs-SDF contacts, particle distance groups
     (Gauss-Seidel ACROSS groups for cloth convergence), attachments
  3. recover velocities from position deltas; apply friction impulses

PhysX parameter mapping: `solver_position_iteration_count` -> `iterations`;
linear/angular damping -> exponential velocity decay; locked_{pos,rot}_axis
bitmasks -> free-axis masks applied to velocity and corrections.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..utils.math import quat_apply, quat_conjugate, quat_mul, quat_normalize
from .types import FixedJointSpec, ParticleState, RigidBodySpec, RigidBodyState, SceneState

GRAVITY_MAG = 9.81
GRAVITY = jnp.array([0.0, 0.0, -GRAVITY_MAG], dtype=jnp.float32)

# Every float32 contraction of the solver runs at full precision: a GPU
# otherwise lowers f32 matmuls to TF32 (10 mantissa bits), which would round
# positions inside the one-hot scatters.
_HIGHEST = jax.lax.Precision.HIGHEST
_einsum = partial(jnp.einsum, precision=_HIGHEST)


# ---------------------------------------------------------------------------
# static (non-pytree) constraint descriptions
# ---------------------------------------------------------------------------

SDFFn = Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]
"""world points [..., 3] -> (signed distance [...], unit normal [..., 3])."""


@dataclasses.dataclass(frozen=True)
class ContactSet:
    """Collision points of one body against one SDF.

    local_points: [P, 3] or [B, P, 3] body-frame sample points.
    sdf: static callable; may close over per-env arrays of shape [B, ...]
         (it receives points shaped [B, P, 3]).
    """

    body: int
    local_points: jnp.ndarray
    sdf: SDFFn
    friction: float = 0.5
    # velocity-pass parameters (XPBD §3.6 velocity solve). Both default to 0,
    # which skips the pass at trace time — existing behavior is unchanged.
    restitution: float = 0.0
    dynamic_friction: float = 0.0

    def __hash__(self):  # static under jit; identity hash is fine
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class BodyPairContact:
    """Two-body contact: sample points on `body_points` against the local-frame
    SDF of `body_sdf` (e.g. pushing-gripper stick vs peg prism —
    rigid_pushing has NO attachment, the stick really pushes the object).
    Impulses are applied to both bodies."""

    body_points: int
    body_sdf: int
    local_points: jnp.ndarray  # [P, 3] or [B, P, 3]
    sdf: SDFFn  # local frame of body_sdf
    friction: float = 0.5
    restitution: float = 0.0
    dynamic_friction: float = 0.0

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class ParticleSDFContact:
    """All particles vs one SDF (cloth/rope vs ground etc.)."""

    sdf: SDFFn
    friction: float = 0.3
    restitution: float = 0.0
    dynamic_friction: float = 0.0

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


class DistanceGroup(NamedTuple):
    """One parallel (conflict-free) group of particle distance constraints.

    Within a group no particle appears twice, so Gauss-Seidel-quality updates
    apply in parallel. Cloth/rope builders emit several groups (graph
    coloring); the solver sweeps groups sequentially each iteration.
    `mask` disables constraints per env (cloth hole cutouts vary per env).
    """

    i: jnp.ndarray  # [C] int32 particle indices
    j: jnp.ndarray  # [C]
    rest: jnp.ndarray  # [C] or [B, C] rest lengths
    compliance: jnp.ndarray  # [C] XPBD compliance (0 = rigid)
    mask: Optional[jnp.ndarray] = None  # [C] or [B, C]; 1 = active


class ParticleSpec(NamedTuple):
    inv_mass: jnp.ndarray  # [NP] or [B, NP]
    lin_damping: float = 0.0


class ParticleSelfContact(NamedTuple):
    """All-pairs particle self-collision (PhysX particle-cloth
    `particle_contact_offset` semantics): any non-excluded pair is pushed
    apart to `min_dist`. Dense [NP, NP] work — lowers to
    batched matmuls/broadcasts, NO scatter (NP is small: cloth 225).

    pair_mask: [NP, NP] static 0/1, excludes self + topologically-constrained
        neighbors (they are kept apart by stretch/shear constraints already).
    active: optional [NP] or [B, NP] per-particle gate (cloth hole cutouts:
        removed particles must not repel cloth moving through the hole).
    """

    min_dist: float
    pair_mask: jnp.ndarray
    active: Optional[jnp.ndarray] = None


class BodyAttachment(NamedTuple):
    """Pin particles to body-local points (cloth corner <-> gripper cube,
    orbit `BodyAttachmentCfg`)."""

    particle: jnp.ndarray  # [A] int32
    body: jnp.ndarray  # [A] int32
    local_pos: jnp.ndarray  # [A, 3] or [B, A, 3]


# ---------------------------------------------------------------------------
# rigid-body helpers
# ---------------------------------------------------------------------------


def _inv_inertia_world(quat: jnp.ndarray, inv_inertia_body: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Apply world-frame inverse inertia to vector u: R I_b^-1 R^T u."""
    u_body = quat_apply(quat_conjugate(quat), u)
    return quat_apply(quat, inv_inertia_body * u_body)


def _gyroscopic_step(quat: jnp.ndarray, w: jnp.ndarray, inv_inertia: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Implicit gyroscopic update of world angular velocity w.

    Solves I*(w1-w0) + dt*w1 x (I*w1) = 0 in the body frame with one Newton
    step (unconditionally stable; explicit w x Iw integration blows up for
    tumbling bodies). Equivalent of PhysX's opt-in
    PxRigidBodyFlag::eENABLE_GYROSCOPIC_FORCES — off by default like PhysX,
    and identically zero for the reference tasks (yaw-only free rotation
    keeps w on a principal axis).
    """
    wb = quat_apply(quat_conjugate(quat), w)
    # diag body inertia; rows with any zero inverse (static/locked bodies)
    # pass through unchanged
    valid = jnp.all(inv_inertia > 0.0, axis=-1)
    ib = jnp.where(inv_inertia > 0.0, 1.0 / jnp.maximum(inv_inertia, 1e-12), 0.0)
    iw = ib * wb

    def skew(u):
        zero = jnp.zeros_like(u[..., 0])
        return jnp.stack(
            [
                jnp.stack([zero, -u[..., 2], u[..., 1]], axis=-1),
                jnp.stack([u[..., 2], zero, -u[..., 0]], axis=-1),
                jnp.stack([-u[..., 1], u[..., 0], zero], axis=-1),
            ],
            axis=-2,
        )

    f = dt * jnp.cross(wb, iw)
    eye = jnp.eye(3, dtype=w.dtype)
    J = ib[..., None] * eye + dt * (jnp.matmul(skew(wb), ib[..., :, None] * eye, precision=_HIGHEST) - skew(iw))
    dwb = jnp.linalg.solve(J, f[..., None])[..., 0]
    wb1 = jnp.where(valid[..., None], wb - dwb, wb)
    return quat_apply(quat, wb1)


def _generalized_inv_mass(
    quat: jnp.ndarray, inv_mass: jnp.ndarray, inv_inertia: jnp.ndarray, r: jnp.ndarray, n: jnp.ndarray
) -> jnp.ndarray:
    """w = 1/m + (r x n)^T I^-1 (r x n) for a positional impulse at offset r."""
    rxn = jnp.cross(r, n)
    return inv_mass + jnp.sum(rxn * _inv_inertia_world(quat, inv_inertia, rxn), axis=-1)


def _apply_impulse(pos, quat, inv_mass, inv_inertia, free_pos, free_rot, r, p):
    """Positional impulse p at world offset r -> (new_pos, new_quat)."""
    dpos = p * inv_mass[..., None] * free_pos
    dw = _inv_inertia_world(quat, inv_inertia, jnp.cross(r, p)) * free_rot
    dq = 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dw[..., :1]), dw], axis=-1), quat)
    return pos + dpos, quat_normalize(quat + dq)


# ---------------------------------------------------------------------------
# constraint solves (one Jacobi pass each)
# ---------------------------------------------------------------------------


def _solve_fixed_joints(
    pos, quat, spec: RigidBodySpec, joints: FixedJointSpec, relax: float = 1.0
):
    """One pass over fixed joints: positional anchor + orientation weld.

    pos/quat: [B, NB, ...]. Corrections for all joints are accumulated
    (scatter-add) then applied — Jacobi over joints, exact for chains where
    each body pair shares one joint (our scenes).
    """
    B, NB = pos.shape[:2]
    ia, ib = joints.body_a, joints.body_b  # [NJ] static
    im_a, ii_a = spec.inv_mass[ia], spec.inv_inertia[ia]
    im_b, ii_b = spec.inv_mass[ib], spec.inv_inertia[ib]

    oh_a = jax.nn.one_hot(ia, NB, dtype=pos.dtype)  # [NJ, NB] constant-folded
    oh_b = jax.nn.one_hot(ib, NB, dtype=pos.dtype)

    # Jacobi averaging: each joint's correction is computed as if it acted
    # alone; a body shared by K joints would accumulate K full corrections
    # (scatter-ADD) and overshoot — the two-agent scenes (two grippers welded
    # to one object) diverge within ~60 control steps without this. Scale
    # each contribution by 1/K of the receiving body; K=1 everywhere else,
    # so single-joint scenes are bit-identical.
    joint_count = jnp.maximum(oh_a.sum(axis=0) + oh_b.sum(axis=0), 1.0)  # [NB] static
    inv_count_a = (1.0 / joint_count)[ia][None, :, None]  # [1, NJ, 1]
    inv_count_b = (1.0 / joint_count)[ib][None, :, None]

    def scatter(vals, idx):
        oh = oh_a if idx is ia else oh_b
        vals = vals * (inv_count_a if idx is ia else inv_count_b)
        return _einsum("jn,bjd->bnd", oh, vals)

    # --- stage 1: orientation weld (drive q_b -> q_a * rel_quat) ----------
    # Applied BEFORE the anchor so the anchor sees welded orientations;
    # computing both from the same state makes them cancel and stalls
    # convergence for lever-arm joints.
    qa, qb = quat[:, ia], quat[:, ib]
    rel = joints.rel_quat if joints.rel_quat.ndim == 3 else joints.rel_quat[None]
    q_target = quat_mul(qa, rel)
    dq = quat_mul(q_target, quat_conjugate(qb))
    sign = jnp.sign(dq[..., :1] + 1e-12)
    theta = 2.0 * dq[..., 1:] * sign  # small-angle rotation vector
    # split by angular weights (scalar approximation with diag inertias)
    wa_r = jnp.sum(ii_a, axis=-1) / 3.0
    wb_r = jnp.sum(ii_b, axis=-1) / 3.0
    denom_r = jnp.maximum(wa_r + wb_r, 1e-12)
    dth_a = -theta * (wa_r / denom_r)[..., None] * relax * spec.free_rot[ia]
    dth_b = theta * (wb_r / denom_r)[..., None] * relax * spec.free_rot[ib]
    dw = scatter(dth_a, ia) + scatter(dth_b, ib)
    dq_all = 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dw[..., :1]), dw], axis=-1), quat)
    quat = quat_normalize(quat + dq_all)

    # --- stage 2: positional anchor (from the welded orientations) --------
    pa, qa = pos[:, ia], quat[:, ia]
    pb, qb = pos[:, ib], quat[:, ib]
    lpa = joints.local_pos_a if joints.local_pos_a.ndim == 3 else joints.local_pos_a[None]
    lpb = joints.local_pos_b if joints.local_pos_b.ndim == 3 else joints.local_pos_b[None]
    ra = quat_apply(qa, jnp.broadcast_to(lpa, (B,) + lpa.shape[-2:]))
    rb = quat_apply(qb, jnp.broadcast_to(lpb, (B,) + lpb.shape[-2:]))
    c = (pa + ra) - (pb + rb)  # [B, NJ, 3] violation
    c_norm = jnp.linalg.norm(c, axis=-1, keepdims=True)
    n = c / jnp.maximum(c_norm, 1e-9)
    wa = _generalized_inv_mass(qa, im_a, ii_a, ra, n)
    wb = _generalized_inv_mass(qb, im_b, ii_b, rb, n)
    lam = -c_norm.squeeze(-1) / jnp.maximum(wa + wb, 1e-12)
    p = lam[..., None] * n * relax

    dpos = scatter(p * im_a[..., None] * spec.free_pos[ia], ia) + scatter(
        -p * im_b[..., None] * spec.free_pos[ib], ib
    )
    dw_a = _inv_inertia_world(qa, ii_a, jnp.cross(ra, p)) * spec.free_rot[ia]
    dw_b = -_inv_inertia_world(qb, ii_b, jnp.cross(rb, p)) * spec.free_rot[ib]
    dw = scatter(dw_a, ia) + scatter(dw_b, ib)

    pos = pos + dpos
    dq_all = 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dw[..., :1]), dw], axis=-1), quat)
    quat = quat_normalize(quat + dq_all)
    return pos, quat


def _solve_body_contacts(pos, quat, prev_pos, prev_quat, spec, contact: ContactSet, mu_scale=1.0):
    """One pass of point-vs-SDF contact for one body, with static friction on
    the substep's tangential motion (PBD-style). Also returns the per-point
    normal lambda [B, P] so the velocity pass can budget dynamic friction
    against the actual contact load (captures load redistribution that a
    penetration proxy misses, e.g. a sliding box tipping onto its leading
    corners)."""
    b = contact.body
    lp = contact.local_points
    if lp.ndim == 2:
        lp = jnp.broadcast_to(lp[None], (pos.shape[0],) + lp.shape)

    p_b, q_b = pos[:, b], quat[:, b]  # [B, ...]
    r = quat_apply(q_b[:, None, :], lp)  # [B, P, 3] world offsets
    world_pts = p_b[:, None, :] + r

    phi, n = contact.sdf(world_pts)  # [B, P], [B, P, 3]
    pen = jnp.minimum(phi, 0.0)  # negative inside
    active = (phi < 0.0).astype(pos.dtype)

    im = spec.inv_mass[b]
    ii = spec.inv_inertia[b]
    w = _generalized_inv_mass(q_b[:, None, :], im, ii, r, n)  # [B, P]
    lam_n = -pen / jnp.maximum(w, 1e-12) * active  # >= 0
    p_imp = lam_n[..., None] * n

    # friction: oppose tangential displacement of the contact point this substep
    prev_r = quat_apply(prev_quat[:, b][:, None, :], lp)
    prev_pts = prev_pos[:, b][:, None, :] + prev_r
    disp = world_pts - prev_pts
    disp_t = disp - jnp.sum(disp * n, axis=-1, keepdims=True) * n
    t_norm = jnp.linalg.norm(disp_t, axis=-1, keepdims=True)
    t_dir = disp_t / jnp.maximum(t_norm, 1e-9)
    w_t = _generalized_inv_mass(q_b[:, None, :], im, ii, r, t_dir)
    lam_t = jnp.minimum(
        t_norm.squeeze(-1) / jnp.maximum(w_t, 1e-12),
        contact.friction * mu_scale * lam_n,
    )
    p_imp = p_imp - (lam_t * active)[..., None] * t_dir

    # sum impulses over contact points -> single body update
    total_p = p_imp.sum(axis=1)
    total_ang = jnp.cross(r, p_imp).sum(axis=1)
    dpos = total_p * im * spec.free_pos[b]
    dw = _inv_inertia_world(q_b, ii, total_ang) * spec.free_rot[b]

    new_p = p_b + dpos
    dq = 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dw[..., :1]), dw], axis=-1), q_b)
    new_q = quat_normalize(q_b + dq)
    return pos.at[:, b].set(new_p), quat.at[:, b].set(new_q), lam_n


def _solve_body_pair_contact(pos, quat, spec, contact: BodyPairContact):
    """One pass of two-body point-vs-SDF contact (normal only + tangential
    damping is left to velocity recovery)."""
    bi, bj = contact.body_points, contact.body_sdf
    lp = contact.local_points
    if lp.ndim == 2:
        lp = jnp.broadcast_to(lp[None], (pos.shape[0],) + lp.shape)

    p_i, q_i = pos[:, bi], quat[:, bi]
    p_j, q_j = pos[:, bj], quat[:, bj]
    r_i = quat_apply(q_i[:, None, :], lp)  # [B,P,3]
    world_pts = p_i[:, None, :] + r_i

    # into body_j local frame
    local_j = quat_apply(quat_conjugate(q_j)[:, None, :], world_pts - p_j[:, None, :])
    phi, n_local = contact.sdf(local_j)
    n = quat_apply(q_j[:, None, :], n_local)  # world-frame normal
    pen = jnp.minimum(phi, 0.0)
    active = (phi < 0.0).astype(pos.dtype)

    r_j = world_pts - p_j[:, None, :]
    im_i, ii_i = spec.inv_mass[bi], spec.inv_inertia[bi]
    im_j, ii_j = spec.inv_mass[bj], spec.inv_inertia[bj]
    w_i = _generalized_inv_mass(q_i[:, None, :], im_i, ii_i, r_i, n)
    w_j = _generalized_inv_mass(q_j[:, None, :], im_j, ii_j, r_j, n)
    lam = -pen / jnp.maximum(w_i + w_j, 1e-12) * active
    p_imp = lam[..., None] * n  # pushes body_i OUT along +n

    # body_i update
    tp = p_imp.sum(axis=1)
    ta = jnp.cross(r_i, p_imp).sum(axis=1)
    new_pi = p_i + tp * im_i * spec.free_pos[bi]
    dwi = _inv_inertia_world(q_i, ii_i, ta) * spec.free_rot[bi]
    new_qi = quat_normalize(q_i + 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dwi[..., :1]), dwi], -1), q_i))
    # body_j update (opposite impulse)
    tpj = (-p_imp).sum(axis=1)
    taj = jnp.cross(r_j, -p_imp).sum(axis=1)
    new_pj = p_j + tpj * im_j * spec.free_pos[bj]
    dwj = _inv_inertia_world(q_j, ii_j, taj) * spec.free_rot[bj]
    new_qj = quat_normalize(q_j + 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dwj[..., :1]), dwj], -1), q_j))

    pos = pos.at[:, bi].set(new_pi).at[:, bj].set(new_pj)
    quat = quat.at[:, bi].set(new_qi).at[:, bj].set(new_qj)
    return pos, quat, lam


def _solve_distance_group(x, inv_mass, group: DistanceGroup, dt):
    """Parallel distance-constraint solve for one conflict-free group.

    Constraint indices are STATIC per task, so the scatter-back is a
    constant one-hot [C, P] contraction."""
    P = x.shape[1]
    xi, xj = x[:, group.i], x[:, group.j]  # [B, C, 3] (static gathers)
    wi = inv_mass[..., group.i] if inv_mass.ndim == 2 else inv_mass[group.i][None]
    wj = inv_mass[..., group.j] if inv_mass.ndim == 2 else inv_mass[group.j][None]
    rest = group.rest if group.rest.ndim == 2 else group.rest[None]

    d = xi - xj
    dist = jnp.linalg.norm(d, axis=-1)
    n = d / jnp.maximum(dist, 1e-9)[..., None]
    c = dist - rest
    alpha = group.compliance[None] / (dt * dt)
    lam = -c / jnp.maximum(wi + wj + alpha, 1e-12)
    if group.mask is not None:
        m = group.mask if group.mask.ndim == 2 else group.mask[None]
        lam = lam * m
    dx = lam[..., None] * n

    # constant-folded one-hot scatter matrices [C, P]
    oh_i = jax.nn.one_hot(group.i, P, dtype=x.dtype)
    oh_j = jax.nn.one_hot(group.j, P, dtype=x.dtype)
    x = x + _einsum("cp,bcd->bpd", oh_i, dx * wi[..., None])
    x = x - _einsum("cp,bcd->bpd", oh_j, dx * wj[..., None])
    return x


def _solve_self_contacts(x, inv_mass, sc: ParticleSelfContact):
    """One Jacobi pass of all-pairs particle separation.

    Each violating pair (i, j) is pushed apart along its axis, split by
    inverse masses; per-particle corrections are averaged over that
    particle's violating pairs (Jacobi relaxation) to avoid overshoot in
    dense fold regions."""
    d = x[:, :, None, :] - x[:, None, :, :]  # [B, N, N, 3]
    dist = jnp.linalg.norm(d + 1e-12, axis=-1)  # eps: grad-safe at i == j
    w = inv_mass if inv_mass.ndim == 2 else inv_mass[None]  # [B?, N]
    pair_w = w[:, :, None] + w[:, None, :]
    viol = jnp.maximum(sc.min_dist - dist, 0.0) * sc.pair_mask
    if sc.active is not None:
        a = sc.active if sc.active.ndim == 2 else sc.active[None]
        viol = viol * a[:, :, None] * a[:, None, :]
    n = d / jnp.maximum(dist, 1e-9)[..., None]
    # i gets +viol * w_i / (w_i + w_j) along n (j gets the mirror when the
    # pair is visited from its row)
    corr = viol / jnp.maximum(pair_w, 1e-12) * w[:, :, None]  # [B, N, N]
    counts = jnp.maximum((viol > 0).sum(axis=-1), 1)  # [B, N]
    dx = _einsum("bij,bijd->bid", corr, n) / counts[..., None]
    return x + dx


def _solve_attachments(x, inv_mass, pos, quat, spec, att: BodyAttachment):
    """Particle <-> body pins. Two-way: both the particle and the body move
    according to their generalized inverse masses."""
    B, NB = pos.shape[:2]
    lp = att.local_pos if att.local_pos.ndim == 3 else att.local_pos[None]
    qb = quat[:, att.body]
    pb = pos[:, att.body]
    r = quat_apply(qb, jnp.broadcast_to(lp, (B,) + lp.shape[-2:]))
    target = pb + r

    xp = x[:, att.particle]
    wp = inv_mass[..., att.particle] if inv_mass.ndim == 2 else inv_mass[att.particle][None]
    im_b = spec.inv_mass[att.body]
    ii_b = spec.inv_inertia[att.body]

    c = xp - target
    c_norm = jnp.linalg.norm(c, axis=-1, keepdims=True)
    n = c / jnp.maximum(c_norm, 1e-9)
    wb = _generalized_inv_mass(qb, im_b, ii_b, r, n)
    lam = -c_norm.squeeze(-1) / jnp.maximum(wp + wb, 1e-12)
    dx = lam[..., None] * n

    oh_p = jax.nn.one_hot(att.particle, x.shape[1], dtype=x.dtype)  # [A, NP] static
    x = x + _einsum("ap,bad->bpd", oh_p, dx * wp[..., None])

    oh_b = jax.nn.one_hot(att.body, NB, dtype=pos.dtype)  # [A, NB] static

    def scatter(vals):
        return _einsum("an,bad->bnd", oh_b, vals)

    p_imp = -dx
    dpos = scatter(p_imp * im_b[..., None] * spec.free_pos[att.body])
    dw_j = _inv_inertia_world(qb, ii_b, jnp.cross(r, p_imp)) * spec.free_rot[att.body]
    dw = scatter(dw_j)
    pos = pos + dpos
    dq = 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(dw[..., :1]), dw], axis=-1), quat)
    quat = quat_normalize(quat + dq)
    return x, pos, quat


# ---------------------------------------------------------------------------
# velocity pass (XPBD "Detailed Rigid Body Simulation" §3.6)
# ---------------------------------------------------------------------------


def _conormal_manifolds(active, n, lam_n, vecs):
    """Soft-cluster active contact points into co-normal manifolds.

    Points p, q share a manifold iff both are active and n_p . n_q > 0.9.
    Returns per-point group aggregates: cnt_safe [B, P] (group size, >= 1),
    n_bar [B, P, 3] (normalized summed group normal), lam_tot [B, P] (summed
    group normal lambda) and the group MEAN of every [B, P, 3] array in
    `vecs`. Every member of a group computes identical aggregates, so a
    group impulse divided by cnt and summed over members applies exactly
    once — per-point independent impulses would over-correct the shared body
    velocity (a box flat on 4 corners would rebound faster than e*v_in),
    while a single global centroid/mean-normal manifold silently cancels
    when normals oppose (a peg straddling both walls of a hole averages to
    a ~zero normal). Co-normal grouping reduces to the single manifold for
    one common-normal contact patch and keeps opposing patches separate.
    """
    pair = active[:, :, None] * active[:, None, :]  # [B, P, P]
    A = (_einsum("bpd,bqd->bpq", n, n) > 0.9) * pair
    cnt_safe = jnp.maximum(A.sum(-1), 1.0)  # [B, P]
    n_sum = _einsum("bpq,bqd->bpd", A, n)
    n_bar = n_sum / jnp.maximum(jnp.linalg.norm(n_sum, axis=-1, keepdims=True), 1e-9)
    lam_tot = _einsum("bpq,bq->bp", A, lam_n)
    means = tuple(
        _einsum("bpq,bqd->bpd", A, v) / cnt_safe[..., None] for v in vecs
    )
    return cnt_safe, n_bar, lam_tot, means


def _manifold_impulse(
    v_pt, v_pt_pre, n_bar, w_of, lam_tot, gate, dt, restitution, dynamic_friction
):
    """Restitution + Coulomb-budget dynamic friction impulse for a manifold.

    v_pt / v_pt_pre [B, P, 3]: (relative) contact-point velocity post-solve
    and pre-solve (approach velocity); w_of(dir) -> generalized inverse mass
    along dir [B, P]; lam_tot: summed normal lambda (the friction budget);
    gate zeroes inactive points. restitution/dynamic_friction are static
    Python floats — a zero branch is omitted from the compiled program.
    """
    vn = jnp.sum(v_pt * n_bar, axis=-1)
    vn_pre = jnp.sum(v_pt_pre * n_bar, axis=-1)
    p = jnp.zeros_like(v_pt)
    if restitution > 0.0:
        # dv_n = -vn + max(-e * vn_pre, 0); threshold suppresses jitter bounce.
        # The -vn stopping term removes the separation velocity the position
        # pushout injected, which is at most lam_tot/dt — cap it there so a
        # contact that is GENUINELY separating (e.g. the far wall of a press
        # fit while the near wall reflects) is not glued back to the surface.
        e = jnp.where(jnp.abs(vn_pre) > 2.0 * GRAVITY_MAG * dt, restitution, 0.0)
        dv_n = (-jnp.minimum(vn, lam_tot / dt) + jnp.maximum(-e * vn_pre, 0.0)) * gate
        p = p + (dv_n / jnp.maximum(w_of(n_bar), 1e-12))[..., None] * n_bar
    if dynamic_friction > 0.0:
        vt = v_pt - vn[..., None] * n_bar
        vt_norm = jnp.linalg.norm(vt, axis=-1)
        t_dir = vt / jnp.maximum(vt_norm, 1e-9)[..., None]
        p_stop = vt_norm / jnp.maximum(w_of(t_dir), 1e-12)
        # Coulomb budget: mu * total normal impulse of the manifold
        p_fric = jnp.minimum(p_stop, dynamic_friction * lam_tot / dt) * gate
        p = p - p_fric[..., None] * t_dir
    return p


def _velocity_pass_body_contact(
    lin_vel, ang_vel, pos, quat, pred_pos, pred_quat, v_pre, w_pre, spec, contact: ContactSet, lam_n, dt
):
    """Restitution + dynamic Coulomb friction for one body-vs-SDF contact set.

    lam_n [B, P]: normal lambda accumulated over the position iterations —
    the actual per-point contact load (captures redistribution onto leading
    points when the body tips while sliding). v_pre/w_pre are pre-solve
    (post-integration) velocities, the approach velocity for restitution.
    """
    b = contact.body
    lp = contact.local_points
    if lp.ndim == 2:
        lp = jnp.broadcast_to(lp[None], (pos.shape[0],) + lp.shape)

    q_b, p_b = quat[:, b], pos[:, b]
    r = quat_apply(q_b[:, None, :], lp)  # [B, P, 3] final-pose offsets
    world_pts = p_b[:, None, :] + r
    phi, n = contact.sdf(world_pts)
    # a point is in contact iff the position solve loaded it AND it is still
    # touching at the final pose (a point that touched in an early iteration
    # but separated must not receive stale-normal impulses)
    active = ((lam_n > 0.0) & (phi < 1e-3)).astype(pos.dtype)  # [B, P]

    pred_r = quat_apply(pred_quat[:, b][:, None, :], lp)
    cnt_safe, n_bar, lam_tot, (r_bar, pred_r_bar) = _conormal_manifolds(
        active, n, lam_n, (r, pred_r)
    )

    im, ii = spec.inv_mass[b], spec.inv_inertia[b]
    w_of = lambda d: _generalized_inv_mass(q_b[:, None, :], im, ii, r_bar, d)  # [B, P]
    v_pt = lin_vel[:, b][:, None, :] + jnp.cross(ang_vel[:, b][:, None, :], r_bar)
    v_pt_pre = v_pre[:, b][:, None, :] + jnp.cross(w_pre[:, b][:, None, :], pred_r_bar)
    p = _manifold_impulse(
        v_pt, v_pt_pre, n_bar, w_of, lam_tot, active, dt,
        contact.restitution, contact.dynamic_friction,
    ) / cnt_safe[..., None]  # [B, P, 3]

    dv = p.sum(axis=1) * im * spec.free_pos[b]
    torque = jnp.cross(r_bar, p).sum(axis=1)
    dw = _inv_inertia_world(q_b, ii, torque) * spec.free_rot[b]
    return lin_vel.at[:, b].add(dv), ang_vel.at[:, b].add(dw)


def _velocity_pass_body_pair_contact(
    lin_vel, ang_vel, pos, quat, pred_pos, pred_quat, v_pre, w_pre, spec, contact: BodyPairContact, lam_n, dt
):
    """Restitution + dynamic Coulomb friction for a two-body contact
    (rigid_pushing stick-vs-prism: PhysX applies material restitution and
    dynamic friction to body-body pairs — scene_cfg.py material props).
    Equal and opposite impulses on both bodies from the RELATIVE
    contact-point velocity; same lambda-budget scheme as ContactSet."""
    bi, bj = contact.body_points, contact.body_sdf
    lp = contact.local_points
    if lp.ndim == 2:
        lp = jnp.broadcast_to(lp[None], (pos.shape[0],) + lp.shape)

    q_i, p_i = quat[:, bi], pos[:, bi]
    q_j, p_j = quat[:, bj], pos[:, bj]
    r_i = quat_apply(q_i[:, None, :], lp)  # [B, P, 3]
    world_pts = p_i[:, None, :] + r_i
    local_j = quat_apply(quat_conjugate(q_j)[:, None, :], world_pts - p_j[:, None, :])
    phi, n_local = contact.sdf(local_j)
    n = quat_apply(q_j[:, None, :], n_local)
    r_j = world_pts - p_j[:, None, :]

    active = ((lam_n > 0.0) & (phi < 1e-3)).astype(pos.dtype)  # [B, P]

    pred_r_i = quat_apply(pred_quat[:, bi][:, None, :], lp)
    pred_pts = pred_pos[:, bi][:, None, :] + pred_r_i
    pred_r_j = pred_pts - pred_pos[:, bj][:, None, :]
    cnt_safe, n_bar, lam_tot, (r_i_bar, r_j_bar, pred_r_i_bar, pred_r_j_bar) = (
        _conormal_manifolds(active, n, lam_n, (r_i, r_j, pred_r_i, pred_r_j))
    )

    im_i, ii_i = spec.inv_mass[bi], spec.inv_inertia[bi]
    im_j, ii_j = spec.inv_mass[bj], spec.inv_inertia[bj]
    w_of = lambda d: _generalized_inv_mass(
        q_i[:, None, :], im_i, ii_i, r_i_bar, d
    ) + _generalized_inv_mass(q_j[:, None, :], im_j, ii_j, r_j_bar, d)

    # relative manifold velocity (post-solve) and pre-solve approach velocity
    v_pt = (
        lin_vel[:, bi][:, None, :]
        + jnp.cross(ang_vel[:, bi][:, None, :], r_i_bar)
        - lin_vel[:, bj][:, None, :]
        - jnp.cross(ang_vel[:, bj][:, None, :], r_j_bar)
    )
    v_pt_pre = (
        v_pre[:, bi][:, None, :]
        + jnp.cross(w_pre[:, bi][:, None, :], pred_r_i_bar)
        - v_pre[:, bj][:, None, :]
        - jnp.cross(w_pre[:, bj][:, None, :], pred_r_j_bar)
    )
    p = _manifold_impulse(
        v_pt, v_pt_pre, n_bar, w_of, lam_tot, active, dt,
        contact.restitution, contact.dynamic_friction,
    ) / cnt_safe[..., None]  # [B, P, 3]

    p_sum = p.sum(axis=1)
    dv_i = p_sum * im_i * spec.free_pos[bi]
    dw_i = _inv_inertia_world(q_i, ii_i, jnp.cross(r_i_bar, p).sum(axis=1)) * spec.free_rot[bi]
    dv_j = -p_sum * im_j * spec.free_pos[bj]
    dw_j = _inv_inertia_world(q_j, ii_j, jnp.cross(r_j_bar, -p).sum(axis=1)) * spec.free_rot[bj]
    lin_vel = lin_vel.at[:, bi].add(dv_i).at[:, bj].add(dv_j)
    ang_vel = ang_vel.at[:, bi].add(dw_i).at[:, bj].add(dw_j)
    return lin_vel, ang_vel


def _velocity_pass_particle_contact(vel, x, v_pre, inv_mass, pc: ParticleSDFContact, lam_p, dt):
    """Restitution + dynamic friction for particles vs one SDF.

    lam_p [B, NP]: normal position corrections accumulated over the position
    iterations — the per-particle contact load, same budget scheme as the
    body path (a particle resting on the surface without predicted
    penetration still carries load from the solver pushing it out)."""
    phi, n = pc.sdf(x)
    active = ((phi < 1e-4) & (lam_p > 0.0)).astype(x.dtype)

    w = inv_mass if inv_mass.ndim == 2 else inv_mass[None]
    vn = jnp.sum(vel * n, axis=-1)
    vn_pre = jnp.sum(v_pre * n, axis=-1)

    dv = jnp.zeros_like(vel)
    if pc.restitution > 0.0:
        e = jnp.where(jnp.abs(vn_pre) > 2.0 * GRAVITY_MAG * dt, pc.restitution, 0.0)
        dv_n = (-vn + jnp.maximum(-e * vn_pre, 0.0)) * active * (w > 0)
        dv = dv + dv_n[..., None] * n
    if pc.dynamic_friction > 0.0:
        vt = vel - vn[..., None] * n
        vt_norm = jnp.linalg.norm(vt, axis=-1)
        t_dir = vt / jnp.maximum(vt_norm, 1e-9)[..., None]
        # velocity budget: friction dv <= mu * (accumulated normal correction)/dt
        dv_max = pc.dynamic_friction * lam_p / dt
        dv_t = jnp.minimum(vt_norm, dv_max) * active * (w > 0)
        dv = dv - dv_t[..., None] * t_dir
    return vel + dv


# ---------------------------------------------------------------------------
# the substep
# ---------------------------------------------------------------------------


def xpbd_substep(
    state: SceneState,
    body_spec: RigidBodySpec,
    dt: float,
    *,
    joints: Optional[FixedJointSpec] = None,
    contacts: Sequence[ContactSet] = (),
    pair_contacts: Sequence[BodyPairContact] = (),
    particle_spec: Optional[ParticleSpec] = None,
    distance_groups: Sequence[DistanceGroup] = (),
    attachments: Optional[BodyAttachment] = None,
    particle_contacts: Sequence[ParticleSDFContact] = (),
    self_contacts: Sequence[ParticleSelfContact] = (),
    iterations: int = 8,
    max_velocity: float = 1e3,
    gyroscopic: bool = False,
) -> SceneState:
    """One physics substep (dt = sim.dt, called `decimation` times per
    control step like RLTaskEnv)."""
    bodies = state.bodies

    # 1. integrate bodies --------------------------------------------------
    lin_damp = jnp.exp(-body_spec.lin_damping * dt)
    ang_damp = jnp.exp(-body_spec.ang_damping * dt)
    v = (bodies.lin_vel + dt * GRAVITY * body_spec.gravity_scale[:, None]) * lin_damp[:, None]
    w = bodies.ang_vel * ang_damp[:, None]
    v = jnp.clip(v * body_spec.free_pos, -max_velocity, max_velocity)
    if gyroscopic:
        w = _gyroscopic_step(bodies.quat, w, body_spec.inv_inertia, dt)
    w = w * body_spec.free_rot

    prev_pos, prev_quat = bodies.pos, bodies.quat
    pos = bodies.pos + dt * v
    w_quat = jnp.concatenate([jnp.zeros_like(w[..., :1]), w], axis=-1)
    quat = quat_normalize(bodies.quat + 0.5 * dt * quat_mul(w_quat, bodies.quat))
    pred_pos, pred_quat = pos, quat  # pre-solve prediction (velocity pass)
    v_pre, w_pre = v, w

    # particles
    if particle_spec is not None and state.particles is not None:
        parts = state.particles
        pv = parts.vel + dt * GRAVITY * (particle_spec.inv_mass > 0)[..., None]
        if particle_spec.lin_damping:
            pv = pv * jnp.exp(-particle_spec.lin_damping * dt)
        prev_x = parts.pos
        x = parts.pos + dt * pv
        pv_pre = pv
    else:
        x = prev_x = pv_pre = None

    # accumulated per-point normal lambdas for contacts that run a velocity
    # pass (restitution / dynamic friction); empty tuples otherwise
    needs_vpass = tuple(c.restitution > 0.0 or c.dynamic_friction > 0.0 for c in contacts)
    lam_init = tuple(
        jnp.zeros(pos.shape[:1] + (c.local_points.shape[-2],), pos.dtype)
        for c, nv in zip(contacts, needs_vpass)
        if nv
    )
    needs_vpass_pair = tuple(
        c.restitution > 0.0 or c.dynamic_friction > 0.0 for c in pair_contacts
    )
    pair_lam_init = tuple(
        jnp.zeros(pos.shape[:1] + (c.local_points.shape[-2],), pos.dtype)
        for c, nv in zip(pair_contacts, needs_vpass_pair)
        if nv
    )
    needs_vpass_part = tuple(
        c.restitution > 0.0 or c.dynamic_friction > 0.0 for c in particle_contacts
    )
    part_lam_init = tuple(
        jnp.zeros(x.shape[:2], x.dtype)
        for nv in needs_vpass_part
        if nv and x is not None
    )

    # 2. position solve -----------------------------------------------------
    def iteration(carry, _):
        pos, quat, x, lams, pair_lams, part_lams = carry
        if joints is not None:
            pos, quat = _solve_fixed_joints(pos, quat, body_spec, joints)
        new_lams = []
        vi = 0
        for contact, nv in zip(contacts, needs_vpass):
            pos, quat, lam_n = _solve_body_contacts(pos, quat, prev_pos, prev_quat, body_spec, contact)
            if nv:
                new_lams.append(lams[vi] + lam_n)
                vi += 1
        lams = tuple(new_lams)
        new_pair_lams = []
        vi = 0
        for contact, nv in zip(pair_contacts, needs_vpass_pair):
            pos, quat, lam_n = _solve_body_pair_contact(pos, quat, body_spec, contact)
            if nv:
                new_pair_lams.append(pair_lams[vi] + lam_n)
                vi += 1
        pair_lams = tuple(new_pair_lams)
        if x is not None:
            for group in distance_groups:
                x = _solve_distance_group(x, particle_spec.inv_mass, group, dt)
            for sc in self_contacts:
                x = _solve_self_contacts(x, particle_spec.inv_mass, sc)
            if attachments is not None:
                x, pos, quat = _solve_attachments(x, particle_spec.inv_mass, pos, quat, body_spec, attachments)
            new_part_lams = []
            vi = 0
            for pc, nv in zip(particle_contacts, needs_vpass_part):
                phi, n = pc.sdf(x)
                pen = jnp.minimum(phi, 0.0)
                dx_n = -pen[..., None] * n
                # particle friction: remove tangential motion at contacts
                disp = (x - prev_x) if prev_x is not None else jnp.zeros_like(x)
                disp_t = disp - jnp.sum(disp * n, axis=-1, keepdims=True) * n
                t_norm = jnp.linalg.norm(disp_t, axis=-1, keepdims=True)
                scale = jnp.minimum(1.0, pc.friction * (-pen[..., None]) / jnp.maximum(t_norm, 1e-9))
                active = (phi < 0.0).astype(x.dtype)[..., None]
                x = x + active * (dx_n - scale * disp_t)
                if nv:
                    new_part_lams.append(part_lams[vi] + (-pen))
                    vi += 1
            part_lams = tuple(new_part_lams)
        return (pos, quat, x, lams, pair_lams, part_lams), None

    (pos, quat, x, lam_acc, pair_lam_acc, part_lam_acc), _ = jax.lax.scan(
        iteration, (pos, quat, x, lam_init, pair_lam_init, part_lam_init), None, length=iterations
    )

    # 3. velocity recovery ---------------------------------------------------
    new_v = (pos - prev_pos) / dt * body_spec.free_pos
    dq_vel = quat_mul(quat, quat_conjugate(prev_quat))
    sign = jnp.sign(dq_vel[..., :1] + 1e-12)
    new_w = 2.0 * dq_vel[..., 1:] * sign / dt * body_spec.free_rot

    # 4. velocity pass (restitution / dynamic friction) — traced only for
    # contacts that request it, so default scenes compile identically
    vi = 0
    for contact, nv in zip(contacts, needs_vpass):
        if nv:
            new_v, new_w = _velocity_pass_body_contact(
                new_v, new_w, pos, quat, pred_pos, pred_quat, v_pre, w_pre,
                body_spec, contact, lam_acc[vi], dt,
            )
            vi += 1
    vi = 0
    for contact, nv in zip(pair_contacts, needs_vpass_pair):
        if nv:
            new_v, new_w = _velocity_pass_body_pair_contact(
                new_v, new_w, pos, quat, pred_pos, pred_quat, v_pre, w_pre,
                body_spec, contact, pair_lam_acc[vi], dt,
            )
            vi += 1

    new_bodies = RigidBodyState(pos=pos, quat=quat, lin_vel=new_v, ang_vel=new_w)
    if x is not None:
        new_pv = (x - prev_x) / dt
        vi = 0
        for pc, nv in zip(particle_contacts, needs_vpass_part):
            if nv:
                new_pv = _velocity_pass_particle_contact(
                    new_pv, x, pv_pre, particle_spec.inv_mass, pc, part_lam_acc[vi], dt
                )
                vi += 1
        new_parts = ParticleState(pos=x, vel=new_pv)
    else:
        new_parts = state.particles
    return SceneState(bodies=new_bodies, particles=new_parts)


def step_physics(state: SceneState, body_spec: RigidBodySpec, dt: float, decimation: int, **kwargs) -> SceneState:
    """`decimation` substeps under one control action (RLTaskEnv semantics)."""
    substep = partial(xpbd_substep, body_spec=body_spec, dt=dt, **kwargs)

    def body(s, _):
        return substep(s), None

    out, _ = jax.lax.scan(body, state, None, length=decimation)
    return out
