"""Geometry math core: quaternions, rigid transforms, sphere grids.

JAX replacement for the `omni.isaac.orbit.utils.math` surface the
reference tasks consume (see SURVEY.md §2.10: `transform_points`, `quat_mul`,
`quat_from_euler_xyz`, `quat_error_magnitude`, `quat_apply_yaw`,
`sample_uniform`) plus the PONITA S2 orientation grids
(reference: geometry_rl/modules/pyg_models/ponita/ponita.py:27-97).

Conventions: quaternions are (w, x, y, z), matching Isaac orbit. All functions
are pure, shape-polymorphic over leading batch dims, and jit/vmap friendly.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(shape: tuple = ()) -> jnp.ndarray:
    """Identity quaternion broadcast to `shape + (4,)`."""
    q = jnp.array([1.0, 0.0, 0.0, 0.0], dtype=jnp.float32)
    return jnp.broadcast_to(q, tuple(shape) + (4,))


def quat_normalize(q: jnp.ndarray, eps: float = 1e-9) -> jnp.ndarray:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), eps)


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product q1 ⊗ q2, wxyz convention."""
    w1, x1, y1, z1 = jnp.split(q1, 4, axis=-1)
    w2, x2, y2, z2 = jnp.split(q2, 4, axis=-1)
    return jnp.concatenate(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_apply(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by quaternion(s) q. Shapes broadcast on leading dims."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_inv_apply(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return quat_apply(quat_conjugate(q), v)


def quat_from_axis_angle(axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Quaternion from unit axis [..., 3] and angle [...]."""
    half = 0.5 * angle[..., None]
    return jnp.concatenate([jnp.cos(half), axis * jnp.sin(half)], axis=-1)


def quat_from_euler_xyz(roll: jnp.ndarray, pitch: jnp.ndarray, yaw: jnp.ndarray) -> jnp.ndarray:
    """Quaternion from XYZ (roll-pitch-yaw) Euler angles (extrinsic x-y-z),
    matching orbit's `quat_from_euler_xyz` semantics."""
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    return jnp.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        axis=-1,
    )


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] from quaternion [..., 4]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def quat_error_magnitude(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle (radians) between two quaternions.

    Matches orbit's `quat_error_magnitude`: the magnitude of the axis-angle of
    q1 ⊗ q2*. Robust atan2 form; returns values in [0, pi].
    """
    dq = quat_mul(q1, quat_conjugate(q2))
    sin_half = jnp.linalg.norm(dq[..., 1:], axis=-1)
    cos_half = jnp.abs(dq[..., 0])
    return 2.0 * jnp.arctan2(sin_half, cos_half)


def quat_apply_yaw(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate v by only the yaw component of q (orbit `quat_apply_yaw`)."""
    return quat_apply(yaw_quat(q), v)


def yaw_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Extract the yaw-only quaternion of q."""
    w, z = q[..., 0], q[..., 3]
    norm = jnp.sqrt(w * w + z * z)
    safe = norm > 1e-9
    w = jnp.where(safe, w / jnp.maximum(norm, 1e-9), 1.0)
    z = jnp.where(safe, z / jnp.maximum(norm, 1e-9), 0.0)
    zeros = jnp.zeros_like(w)
    return jnp.stack([w, zeros, zeros, z], axis=-1)


def quat_integrate(q: jnp.ndarray, omega: jnp.ndarray, dt: float) -> jnp.ndarray:
    """First-order quaternion integration under world-frame angular velocity."""
    dq = 0.5 * quat_mul(jnp.concatenate([jnp.zeros_like(omega[..., :1]), omega], axis=-1), q)
    return quat_normalize(q + dt * dq)


# ---------------------------------------------------------------------------
# Rigid transforms
# ---------------------------------------------------------------------------


def transform_points(points: jnp.ndarray, pos: jnp.ndarray, quat: jnp.ndarray) -> jnp.ndarray:
    """World-transform local points: R(quat) @ p + pos.

    points: [..., N, 3]; pos: [..., 3]; quat: [..., 4] (broadcast over N).
    Mirrors orbit `transform_points` used by the observation extractor
    (reference: rigid_tasks/mdp/observations.py:100-110).
    """
    return quat_apply(quat[..., None, :], points) + pos[..., None, :]


def inverse_transform_points(points: jnp.ndarray, pos: jnp.ndarray, quat: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `transform_points`: R(quat)^T @ (p - pos)."""
    return quat_inv_apply(quat[..., None, :], points - pos[..., None, :])


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sample_uniform(key: jax.Array, lower, upper, shape: tuple) -> jnp.ndarray:
    """Uniform sample in [lower, upper) — orbit `sample_uniform` equivalent."""
    lower = jnp.asarray(lower, dtype=jnp.float32)
    upper = jnp.asarray(upper, dtype=jnp.float32)
    return jax.random.uniform(key, shape, dtype=jnp.float32) * (upper - lower) + lower


# ---------------------------------------------------------------------------
# Sphere grids (PONITA orientation grids)
# ---------------------------------------------------------------------------


def s1_grid(n: int) -> jnp.ndarray:
    """n equally spaced points on S1 -> [n, 2]."""
    angles = jnp.linspace(0.0, 2 * math.pi - (2 * math.pi / n), n)
    return jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=1)


def fibonacci_lattice(n: int, offset: float = 0.5, upper_hemisphere: bool = False) -> jnp.ndarray:
    """~uniform S2 grid via the Fibonacci spiral -> [n, 3].

    With `upper_hemisphere=True`, the polar angle is restricted to [0, pi/2]
    (reference: ponita.py:87-97 — HEPi configs use `only_upper_hemisphere`).
    """
    i = jnp.arange(n, dtype=jnp.float32)
    theta = (math.pi * i * (1 + math.sqrt(5.0))) % (2 * math.pi)
    scale = 1.0 if upper_hemisphere else 2.0
    phi = jnp.arccos(1 - scale * (i + offset) / (n - 1 + 2 * offset))
    return jnp.stack(
        [jnp.cos(theta) * jnp.sin(phi), jnp.sin(theta) * jnp.sin(phi), jnp.cos(phi)],
        axis=-1,
    )


def orientation_grid(dim: int, n: int, upper_hemisphere: bool = False) -> jnp.ndarray:
    """PONITA GridGenerator equivalent: S1 (dim=2) or S2 (dim=3) grid."""
    if dim == 2:
        return s1_grid(n)
    if dim == 3:
        return fibonacci_lattice(n, upper_hemisphere=upper_hemisphere)
    raise ValueError("Only S1 (dim=2) and S2 (dim=3) are supported.")
