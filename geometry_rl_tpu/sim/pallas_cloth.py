"""Fused cloth position solve: one GPU kernel launch per substep.

The XLA solver (sim/xpbd.py) runs every constraint group of every solver
iteration as its own fusions, so one cloth substep is several hundred small
kernel launches over a few KB of state per env. This kernel runs the whole
position solve of a substep in one launch through Pallas on the Triton route:

- one program per env; its state is the output buffer (a few KB, resident
  in L1/L2), read and written in place;
- a distance pass gathers both endpoints of every constraint of one
  conflict-free group with indexed loads and stores the corrections back
  with plain stores (no atomics: no particle appears twice in a group,
  envs/cloth.py `grid_constraints`; padded lanes all use one spare row);
  a block barrier separates passes;
- all arithmetic is elementwise float32 (no dot products), in the order of
  `_solve_distance_group` / `_solve_attachments` / the particle SDF contact
  in sim/xpbd.py, so the two solvers agree up to rounding.

Gripper cubes are appended as pseudo-particles: cloth cubes have rotation
locked and attach at their center of mass, so their rigid dynamics reduce
exactly to point dynamics. Self-collision and the velocity-pass material are
not implemented here; envs/cloth.py keeps those on the XLA solver.

`interpret=True` runs the kernel on the CPU (tests only): the Pallas
interpreter executes programs one after another, so the barrier is a no-op
there.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .types import ClothSolveSpec


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def kernel_rows(num_points: int) -> int:
    """Rows of the kernel's state planes: a power of two with at least one
    spare row, which padded constraint lanes read and write."""
    return _next_pow2(num_points + 1)


def pack_groups(groups, num_points: int):
    """Pack distance-constraint groups (each with `i`, `j`, `rest` [C] and
    `mask` [B, C]) into the kernel's padded layout; num_points: particles +
    pseudo-particles. Returns (i [NG, CP] int32, j, rest [NG, CP] f32,
    mask [B, NG, CP] f32) with NG and CP padded to powers of two. Padded
    lanes point both ends at the spare last row with mask 0, so their stores
    change nothing a real constraint reads or writes."""
    ng = _next_pow2(len(groups))
    cp = _next_pow2(max(int(g.i.shape[0]) for g in groups))
    spare = kernel_rows(num_points) - 1

    def pad(arrs, dtype, fill, lead=()):
        out = jnp.full(lead + (ng, cp), fill, dtype)
        for g, a in enumerate(arrs):
            out = out.at[..., g, : a.shape[-1]].set(a.astype(dtype))
        return out

    B = groups[0].mask.shape[0]
    return (
        pad([g.i for g in groups], jnp.int32, spare),
        pad([g.j for g in groups], jnp.int32, spare),
        pad([g.rest for g in groups], jnp.float32, 0.0),
        pad([g.mask for g in groups], jnp.float32, 0.0, (B,)),
    )


def _kernel(spec: ClothSolveSpec, interpret: bool, x_ref, prev_ref, w_ref, hanger_ref, bw_ref, attp_ref,
            gi_ref, gj_ref, grest_ref, gmask_ref, o_ref):
    P, G = spec.num_particles, spec.num_bodies
    PTp = o_ref.shape[-1]
    dt2 = spec.dt * spec.dt
    barrier = (lambda: None) if interpret else plgpu.debug_barrier

    for k in range(3):
        o_ref[k, :] = x_ref[k, :]
    barrier()

    is_cloth = jnp.arange(PTp, dtype=jnp.int32) < P
    att_p = attp_ref[:]
    att_b = P + jnp.arange(G, dtype=jnp.int32)
    bw = bw_ref[:]
    h = [hanger_ref[k] for k in range(3)]

    def distance_pass(g):
        i, j = gi_ref[g, :], gj_ref[g, :]
        wi, wj = w_ref[i], w_ref[j]
        xi = [o_ref[k, i] for k in range(3)]
        xj = [o_ref[k, j] for k in range(3)]
        d = [a - b for a, b in zip(xi, xj)]
        dist = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        alpha = spec.group_compliance[g] / dt2
        lam = -(dist - grest_ref[g, :]) / jnp.maximum(wi + wj + alpha, 1e-12) * gmask_ref[g, :]
        safe = jnp.maximum(dist, 1e-9)
        for k in range(3):
            dx = lam * (d[k] / safe)
            o_ref[k, i] = xi[k] + dx * wi
            o_ref[k, j] = xj[k] - dx * wj
        barrier()

    def attachment_pass():
        wp = w_ref[att_p]
        xp = [o_ref[k, att_p] for k in range(3)]
        xb = [o_ref[k, att_b] for k in range(3)]
        c = [a - b for a, b in zip(xp, xb)]
        c_norm = jnp.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
        safe = jnp.maximum(c_norm, 1e-9)
        lam = -c_norm / jnp.maximum(wp + bw, 1e-12)
        for k in range(3):
            dx = lam * (c[k] / safe)
            o_ref[k, att_p] = xp[k] + dx * wp
            o_ref[k, att_b] = xb[k] - dx * bw
        barrier()

    def contact_pass():
        x = [o_ref[k, :] for k in range(3)]
        rel = [x[k] - h[k] for k in range(3)]
        y = jnp.clip(rel[1], 0.0, 2 * spec.hook_half_len)
        d = [rel[0], rel[1] - y, rel[2]]
        dist = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        phi = dist - spec.hook_radius
        safe = jnp.maximum(dist, 1e-9)
        n = [dk / safe for dk in d]
        pen = jnp.minimum(phi, 0.0)
        disp = [x[k] - prev_ref[k, :] for k in range(3)]
        dot = disp[0] * n[0] + disp[1] * n[1] + disp[2] * n[2]
        disp_t = [disp[k] - dot * n[k] for k in range(3)]
        t_norm = jnp.sqrt(disp_t[0] * disp_t[0] + disp_t[1] * disp_t[1] + disp_t[2] * disp_t[2])
        scale = jnp.minimum(1.0, spec.hook_friction * (-pen) / jnp.maximum(t_norm, 1e-9))
        active = jnp.where((phi < 0.0) & is_cloth, 1.0, 0.0)
        for k in range(3):
            o_ref[k, :] = x[k] + active * (-pen * n[k] - scale * disp_t[k])
        barrier()

    def iteration(_, carry):
        for g in range(len(spec.group_compliance)):
            distance_pass(g)
        attachment_pass()
        contact_pass()
        return carry

    jax.lax.fori_loop(0, spec.iterations, iteration, 0)


@partial(jax.jit, static_argnames=("spec", "interpret"))
def cloth_position_solve(
    spec: ClothSolveSpec,
    x: jnp.ndarray,  # [B, PT, 3] predicted positions (cloth + gripper pseudo-particles)
    prev_x: jnp.ndarray,  # [B, PT, 3] positions at the start of the substep
    inv_mass: jnp.ndarray,  # [B, PT]
    hanger: jnp.ndarray,  # [B, 3]
    att_body_w: jnp.ndarray,  # [B, G] inverse mass of the attached bodies
    att_particle: jnp.ndarray,  # [G] int32 corner particle indices
    packed_groups,  # pack_groups(...) output
    *,
    interpret: bool = False,
) -> jnp.ndarray:
    """Solved positions [B, PT, 3] after `spec.iterations` solver iterations."""
    B, PT, _ = x.shape
    G = att_body_w.shape[1]
    PTp = kernel_rows(PT)
    gi, gj, grest, gmask = packed_groups
    ng, cp = gi.shape

    def planes(a):  # [B, PT, 3] -> [B, 4, PTp]: coordinate planes, padded
        return jnp.pad(jnp.transpose(a, (0, 2, 1)), ((0, 0), (0, 1), (0, PTp - PT)))

    operands = (
        planes(x),
        planes(prev_x),
        jnp.pad(inv_mass, ((0, 0), (0, PTp - PT))),
        jnp.pad(hanger, ((0, 0), (0, 1))),
        att_body_w,
        att_particle.astype(jnp.int32),
        gi,
        gj,
        grest,
        gmask,
    )
    per_env = lambda *shape: pl.BlockSpec((None,) + shape, lambda b: (b,) + (0,) * len(shape))
    shared = lambda *shape: pl.BlockSpec(shape, lambda b: (0,) * len(shape))
    out = pl.pallas_call(
        partial(_kernel, spec, interpret),
        grid=(B,),
        in_specs=[
            per_env(4, PTp),
            per_env(4, PTp),
            per_env(PTp),
            per_env(4),
            per_env(G),
            shared(G),
            shared(ng, cp),
            shared(ng, cp),
            shared(ng, cp),
            per_env(ng, cp),
        ],
        out_specs=per_env(4, PTp),
        out_shape=jax.ShapeDtypeStruct((B, 4, PTp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="cloth_position_solve",
    )(*operands)
    return jnp.transpose(out[:, :3, :PT], (0, 2, 1))
