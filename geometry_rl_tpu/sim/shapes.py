"""Procedural peg/hole geometry — the multi-asset "varying shapes" mechanism.

The reference spawns 8 peg USD meshes + matching hole plates round-robin over
envs (rigid_insertion_multi_env_cfg.py:26-62, sim_utils.py multi-asset
spawner). Those USD assets are stripped from the repo
(.MISSING_LARGE_BLOBS), so this module re-authors them procedurally:

- 2D polygon outlines for plus / pentagon / star / T / diamond / heart /
  hexagon / triangle cross-sections,
- prism meshes (points + edges) for the per-node geometric observations the
  tasks build from USD meshes (tasks/common/utils.py:150-230 — points,
  edges-from-faces, per-env padding with counts),
- analytic polygon SDFs for contact: peg surface points vs hole-plate SDF
  (plate slab minus the hole prism) and vs the ground plane.

All shapes are padded to a common max vertex count with masks, so the whole
multi-asset scene is one static-shaped batch: env e uses shape e % 8, exactly
like `assign_subarray_indices` round-robin (sim_utils.py:21-33).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

SHAPE_NAMES = ("plus", "pentagon", "star", "T", "diamond", "heart", "hexagon", "triangle")


# ---------------------------------------------------------------------------
# 2D outlines (unit scale ~[-1, 1], CCW)
# ---------------------------------------------------------------------------


def _regular_polygon(n: int, radius: float = 1.0, phase: float = 0.0) -> np.ndarray:
    ang = phase + 2 * np.pi * np.arange(n) / n
    return np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=-1)


def _star(n_spikes: int = 5, r_out: float = 1.0, r_in: float = 0.45) -> np.ndarray:
    ang = np.pi / 2 + 2 * np.pi * np.arange(2 * n_spikes) / (2 * n_spikes)
    r = np.where(np.arange(2 * n_spikes) % 2 == 0, r_out, r_in)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)


def _plus(arm: float = 1.0, thick: float = 0.4) -> np.ndarray:
    a, t = arm, thick
    return np.array(
        [
            (t, t), (t, a), (-t, a), (-t, t), (-a, t), (-a, -t),
            (-t, -t), (-t, -a), (t, -a), (t, -t), (a, -t), (a, t),
        ]
    )


def _tee(width: float = 1.0, bar: float = 0.4, stem: float = 0.4) -> np.ndarray:
    w, b, s = width, bar, stem
    return np.array(
        [
            (w, 1.0), (-w, 1.0), (-w, 1.0 - 2 * b), (-s / 2, 1.0 - 2 * b),
            (-s / 2, -1.0), (s / 2, -1.0), (s / 2, 1.0 - 2 * b), (w, 1.0 - 2 * b),
        ]
    )[::-1].copy()  # listed CW; reverse to CCW


def _ensure_ccw(o: np.ndarray) -> np.ndarray:
    x, y = o[:, 0], o[:, 1]
    area = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return o if area > 0 else o[::-1].copy()


def _diamond() -> np.ndarray:
    return np.array([(1.0, 0.0), (0.0, 1.4), (-1.0, 0.0), (0.0, -1.4)])


def _heart(n: int = 16) -> np.ndarray:
    # classic heart curve, normalized to ~unit radius
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = 16 * np.sin(t) ** 3
    y = 13 * np.cos(t) - 5 * np.cos(2 * t) - 2 * np.cos(3 * t) - np.cos(4 * t)
    pts = np.stack([x, y], axis=-1) / 16.0
    return pts[::-1]  # CCW


def _triangle() -> np.ndarray:
    return _regular_polygon(3, radius=1.0, phase=np.pi / 2)


def _letter_a(w: float = 0.8, t: float = 0.35) -> np.ndarray:
    # simplified solid "A" silhouette (triangle with flat feet), no counter
    return np.array(
        [
            (w, -1.0), (w - t, -1.0), (0.35, 0.2), (-0.35, 0.2),
            (-(w - t), -1.0), (-w, -1.0), (-0.25, 1.0), (0.25, 1.0),
        ]
    )


def _letter_e(w: float = 0.7, t: float = 0.3) -> np.ndarray:
    # solid "E" outline
    return np.array(
        [
            (w, 1.0), (-w, 1.0), (-w, -1.0), (w, -1.0), (w, -1.0 + t),
            (-w + t, -1.0 + t), (-w + t, -t / 2), (w * 0.7, -t / 2),
            (w * 0.7, t / 2), (-w + t, t / 2), (-w + t, 1.0 - t), (w, 1.0 - t),
        ]
    )[::-1].copy()


def _letter_l(w: float = 0.9, t: float = 0.4) -> np.ndarray:
    # "L" silhouette — the sliding/pushing default object (L_3.usda,
    # rigid_tasks/config/common_cfg/scene_cfg.py:27-50)
    return np.array(
        [(-w, 1.0), (-w, -1.0), (w, -1.0), (w, -1.0 + t), (-w + t, -1.0 + t), (-w + t, 1.0)]
    )[::-1].copy()


SHAPE_OUTLINES: Dict[str, np.ndarray] = {
    name: _ensure_ccw(outline)
    for name, outline in {
        "plus": _plus(),
        "pentagon": _regular_polygon(5, phase=np.pi / 2),
        "star": _star(),
        "T": _tee(),
        "diamond": _diamond(),
        "heart": _heart(),
        "hexagon": _regular_polygon(6),
        "triangle": _triangle(),
        # extra shapes: pushing uses 10 (adds A, E —
        # rigid_pushing_multi_env_cfg.py:22-43); sliding uses the L object
        "A": _letter_a(),
        "E": _letter_e(),
        "L": _letter_l(),
    }.items()
}

PUSHING_SHAPE_NAMES = ("plus", "pentagon", "star", "T", "A", "E", "diamond", "heart", "hexagon", "triangle")


# ---------------------------------------------------------------------------
# prism meshes (observation geometry)
# ---------------------------------------------------------------------------


class ShapeSet(NamedTuple):
    """Padded multi-shape geometry batch (all arrays static-shaped).

    points/edges mirror the reference's padded per-env geometry tensors
    (tasks/common/utils.py:196-230: points padded with a far-away sentinel,
    edges padded with -1; here masks carry validity instead).
    """

    names: Tuple[str, ...]
    points: jnp.ndarray  # [S, P_max, 3] local-frame mesh points
    point_mask: jnp.ndarray  # [S, P_max]
    num_points: jnp.ndarray  # [S]
    edges: jnp.ndarray  # [S, E_max, 2] indices into points
    edge_mask: jnp.ndarray  # [S, E_max]
    num_edges: jnp.ndarray  # [S]
    outline: jnp.ndarray  # [S, K_max, 2] polygon outline (scaled)
    outline_mask: jnp.ndarray  # [S, K_max]
    surface_points: jnp.ndarray  # [S, C_max, 3] contact sample points
    half_height: float
    scale: float


def prism_mesh(outline: np.ndarray, half_height: float) -> Tuple[np.ndarray, np.ndarray]:
    """Extrude a 2D outline to a prism: points [2K, 3], edges (outline top +
    bottom rings + verticals) [3K, 2]."""
    k = outline.shape[0]
    bottom = np.concatenate([outline, np.full((k, 1), -half_height)], axis=-1)
    top = np.concatenate([outline, np.full((k, 1), half_height)], axis=-1)
    points = np.concatenate([bottom, top], axis=0)
    ring_b = np.stack([np.arange(k), (np.arange(k) + 1) % k], axis=-1)
    ring_t = ring_b + k
    vertical = np.stack([np.arange(k), np.arange(k) + k], axis=-1)
    edges = np.concatenate([ring_b, ring_t, vertical], axis=0)
    return points, edges


def surface_samples(outline: np.ndarray, half_height: float, n_z: int = 3) -> np.ndarray:
    """Contact sample points: outline vertices + edge midpoints at n_z
    z-levels (bottom, middle, top)."""
    mids = 0.5 * (outline + np.roll(outline, -1, axis=0))
    ring = np.concatenate([outline, mids], axis=0)
    zs = np.linspace(-half_height, half_height, n_z)
    pts = np.concatenate([np.concatenate([ring, np.full((len(ring), 1), z)], axis=-1) for z in zs], axis=0)
    return pts


def build_shape_set(
    names=SHAPE_NAMES, scale: float = 0.1, half_height: float = 0.05, clearance: float = 0.0
) -> ShapeSet:
    """Build the padded 8-shape batch at physical scale (outline units ~[-1,1]
    mapped to `scale` meters)."""
    outlines = [SHAPE_OUTLINES[n] * scale for n in names]
    meshes = [prism_mesh(o, half_height) for o in outlines]
    samples = [surface_samples(o, half_height) for o in outlines]

    p_max = max(m[0].shape[0] for m in meshes)
    e_max = max(m[1].shape[0] for m in meshes)
    k_max = max(o.shape[0] for o in outlines)
    c_max = max(s.shape[0] for s in samples)

    S = len(names)
    points = np.zeros((S, p_max, 3), np.float32)
    pmask = np.zeros((S, p_max), np.float32)
    edges = np.zeros((S, e_max, 2), np.int32)
    emask = np.zeros((S, e_max), np.float32)
    outline_arr = np.zeros((S, k_max, 2), np.float32)
    omask = np.zeros((S, k_max), np.float32)
    surf = np.zeros((S, c_max, 3), np.float32)
    n_pts = np.zeros((S,), np.int32)
    n_edg = np.zeros((S,), np.int32)

    for i, ((pts, edg), o, sp) in enumerate(zip(meshes, outlines, samples)):
        points[i, : len(pts)] = pts
        pmask[i, : len(pts)] = 1.0
        edges[i, : len(edg)] = edg
        emask[i, : len(edg)] = 1.0
        outline_arr[i, : len(o)] = o * (1.0 + clearance)
        # pad by repeating the FIRST vertex (see polygon_sdf_2d contract)
        outline_arr[i, len(o) :] = o[0] * (1.0 + clearance)
        omask[i, : len(o)] = 1.0
        surf[i, : len(sp)] = sp
        surf[i, len(sp) :] = sp[-1]  # repeat (extra identical contact points)
        n_pts[i] = len(pts)
        n_edg[i] = len(edg)

    return ShapeSet(
        names=tuple(names),
        points=jnp.asarray(points),
        point_mask=jnp.asarray(pmask),
        num_points=jnp.asarray(n_pts),
        edges=jnp.asarray(edges),
        edge_mask=jnp.asarray(emask),
        num_edges=jnp.asarray(n_edg),
        outline=jnp.asarray(outline_arr),
        outline_mask=jnp.asarray(omask),
        surface_points=jnp.asarray(surf),
        half_height=half_height,
        scale=scale,
    )


# ---------------------------------------------------------------------------
# analytic polygon SDF
# ---------------------------------------------------------------------------


def polygon_sdf_2d(q: jnp.ndarray, verts: jnp.ndarray, vert_mask: jnp.ndarray = None) -> jnp.ndarray:
    """Signed distance of 2D points to a padded polygon.

    q: [..., 2]; verts: [K, 2], padded by REPEATING THE FIRST VERTEX — the
    closing segment (last real vertex -> v0-copy) then carries real geometry
    and all further pad segments are zero-length, contributing neither
    distance error (they sit on a boundary vertex) nor ray crossings.
    `vert_mask` is accepted for interface symmetry but unused. Negative
    inside. O(K) per query, fully vectorized.
    """
    a = verts  # [K, 2]
    b = jnp.roll(verts, -1, axis=0)

    qe = q[..., None, :]  # [..., 1, 2]
    e = b - a  # [K, 2]
    w = qe - a  # [..., K, 2]
    ee = jnp.maximum(jnp.sum(e * e, axis=-1), 1e-12)
    t = jnp.clip(jnp.sum(w * e, axis=-1) / ee, 0.0, 1.0)
    diff = w - t[..., None] * e
    d2 = jnp.sum(diff * diff, axis=-1)  # [..., K]
    dist = jnp.sqrt(jnp.min(d2, axis=-1))

    # even-odd crossing test (degenerate pad segments never straddle)
    qy = q[..., None, 1]
    cond = (a[:, 1] <= qy) != (b[:, 1] <= qy)
    x_int = a[:, 0] + (qy - a[:, 1]) / jnp.where(jnp.abs(e[:, 1]) < 1e-12, 1e-12, e[:, 1]) * e[:, 0]
    crossing = cond & (q[..., None, 0] < x_int)
    inside = jnp.sum(crossing.astype(jnp.int32), axis=-1) % 2 == 1
    return jnp.where(inside, -dist, dist)


def polygon_sdf_grad_2d(q: jnp.ndarray, verts: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Signed distance AND analytic gradient of 2D points to a padded polygon
    (pad-by-first-vertex convention, see polygon_sdf_2d).

    grad = (q - q*) / phi where q* is the closest boundary point: for outside
    points this is the outward unit vector from the boundary; for inside
    points the sign flip makes it point toward the boundary — exactly
    d(phi)/dq wherever phi is differentiable.
    """
    a = verts
    b = jnp.roll(verts, -1, axis=0)
    qe = q[..., None, :]
    e = b - a
    w = qe - a
    ee = jnp.maximum(jnp.sum(e * e, axis=-1), 1e-12)
    t = jnp.clip(jnp.sum(w * e, axis=-1) / ee, 0.0, 1.0)
    closest = a + t[..., None] * e  # [..., K, 2]
    diff = qe - closest
    d2 = jnp.sum(diff * diff, axis=-1)
    # select the closest point without argmin+gather: reduce to the min then
    # average the (usually unique) minimizers via a mask
    d2_min = jnp.min(d2, axis=-1, keepdims=True)
    dist = jnp.sqrt(d2_min[..., 0])
    sel = (d2 <= d2_min + 1e-12).astype(q.dtype)
    qstar = jnp.sum(sel[..., None] * closest, axis=-2) / jnp.maximum(
        jnp.sum(sel, axis=-1, keepdims=True), 1.0
    )

    qy = q[..., None, 1]
    cond = (a[:, 1] <= qy) != (b[:, 1] <= qy)
    x_int = a[:, 0] + (qy - a[:, 1]) / jnp.where(jnp.abs(e[:, 1]) < 1e-12, 1e-12, e[:, 1]) * e[:, 0]
    crossing = cond & (q[..., None, 0] < x_int)
    inside = jnp.sum(crossing.astype(jnp.int32), axis=-1) % 2 == 1

    phi = jnp.where(inside, -dist, dist)
    grad = (q - qstar) / jnp.where(jnp.abs(phi) < 1e-9, 1e-9, phi)[..., None]
    return phi, grad


def hole_plate_sdf(
    points_local: jnp.ndarray,
    outline: jnp.ndarray,
    outline_mask: jnp.ndarray,
    plate_half_extent: float,
    plate_top: float,
    plate_bottom: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SDF of a square plate with a shape-hole, in the plate's local frame.

    The solid is: { |x|,|y| <= plate_half_extent, bottom <= z <= top } minus
    the hole prism { polygon(x,y) < 0 }. Normals are analytic subgradients of
    the max-composition (one polygon evaluation per query — the previous
    finite-difference version needed seven).

    Returns (phi [...], normal [..., 3]) with phi < 0 inside the solid.
    """
    x, y, z = points_local[..., 0], points_local[..., 1], points_local[..., 2]
    q2 = points_local[..., :2]
    zeros = jnp.zeros_like(x)

    # slab SDF (plate without hole): max of face distances, with face normals
    dx = jnp.abs(x) - plate_half_extent
    dy = jnp.abs(y) - plate_half_extent
    z_low = plate_bottom - z
    z_high = z - plate_top
    dz = jnp.maximum(z_low, z_high)
    n_z = jnp.stack([zeros, zeros, jnp.where(z_high >= z_low, 1.0, -1.0)], axis=-1)
    slab = jnp.maximum(jnp.maximum(dx, dy), dz)
    n_slab = jnp.where(
        (dx >= dy)[..., None] & (dx >= dz)[..., None],
        jnp.stack([jnp.sign(x), zeros, zeros], axis=-1),
        jnp.where((dy >= dz)[..., None], jnp.stack([zeros, jnp.sign(y), zeros], axis=-1), n_z),
    )

    poly, poly_grad = polygon_sdf_grad_2d(q2, outline)
    # solid = slab \ hole  ->  phi = max(slab, -hole_prism) with
    # hole_prism = max(poly, dz) (prism only exists within the slab's z range)
    hole_prism = jnp.maximum(poly, dz)
    n_hole = jnp.where(
        (poly >= dz)[..., None],
        jnp.concatenate([poly_grad, zeros[..., None]], axis=-1),
        n_z,
    )
    phi = jnp.maximum(slab, -hole_prism)
    n = jnp.where((slab >= -hole_prism)[..., None], n_slab, -n_hole)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return phi, n


def ground_sdf(points: jnp.ndarray, height: float = 0.0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ground plane z = height (GroundPlaneCfg equivalent)."""
    phi = points[..., 2] - height
    n = jnp.zeros_like(points).at[..., 2].set(1.0)
    return phi, n
