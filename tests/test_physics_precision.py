"""The solver's float32 contractions run at full precision.

A GPU lowers float32 matmuls to TF32 (10 mantissa bits) unless told
otherwise, which would round positions inside the one-hot scatters. Every
contraction of sim/xpbd.py goes through one helper that asks for
`Precision.HIGHEST`; these tests check, for each of the four contraction
sites, that the traced program carries that precision and that the result
matches a float64 reference of the same contraction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometry_rl_tpu.sim import xpbd
from geometry_rl_tpu.sim.types import FixedJointSpec, RigidBodySpec

B, NB, P = 3, 4, 12


def _spec():
    return RigidBodySpec(
        inv_mass=jnp.asarray([1.0, 0.5, 2.0, 0.25]),
        inv_inertia=jnp.full((NB, 3), 3.0),
        gravity_scale=jnp.ones(NB),
        lin_damping=jnp.zeros(NB),
        ang_damping=jnp.zeros(NB),
        free_pos=jnp.ones((NB, 3)),
        free_rot=jnp.ones((NB, 3)),
    )


def _bodies(key):
    k1, k2 = jax.random.split(key)
    pos = jax.random.normal(k1, (B, NB, 3))
    quat = jax.random.normal(k2, (B, NB, 4))
    return pos, quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)


def _site_fixed_joints(key):
    pos, quat = _bodies(key)
    joints = FixedJointSpec(
        body_a=jnp.asarray([0, 1, 2]),
        body_b=jnp.asarray([1, 2, 3]),
        local_pos_a=jnp.full((3, 3), 0.1),
        local_pos_b=jnp.full((3, 3), -0.1),
        rel_quat=jnp.tile(jnp.asarray([1.0, 0.0, 0.0, 0.0]), (3, 1)),
    )
    return lambda: xpbd._solve_fixed_joints(pos, quat, _spec(), joints)


def _site_distance_group(key):
    x = jax.random.normal(key, (B, P, 3))
    inv_mass = jnp.linspace(0.5, 2.0, B * P).reshape(B, P)
    group = xpbd.DistanceGroup(
        i=jnp.asarray([0, 2, 4, 6, 8]),
        j=jnp.asarray([1, 3, 5, 7, 9]),
        rest=jnp.full((5,), 0.3),
        compliance=jnp.full((5,), 1e-4),
        mask=jnp.ones((B, 5)),
    )
    return lambda: xpbd._solve_distance_group(x, inv_mass, group, 0.01)


def _site_attachments(key):
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, (B, P, 3))
    pos, quat = _bodies(k2)
    att = xpbd.BodyAttachment(
        particle=jnp.asarray([0, 5, 11]), body=jnp.asarray([0, 2, 3]), local_pos=jnp.full((3, 3), 0.05)
    )
    return lambda: xpbd._solve_attachments(x, jnp.ones((B, P)), pos, quat, _spec(), att)


def _site_conormal_manifolds(key):
    k1, k2, k3 = jax.random.split(key, 3)
    n = jax.random.normal(k1, (B, P, 3))
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    active = (jax.random.uniform(k2, (B, P)) > 0.3).astype(jnp.float32)
    lam = jax.random.uniform(k3, (B, P))
    return lambda: xpbd._conormal_manifolds(active, n, lam, (n * 2.0,))


SITES = {
    "fixed_joints": _site_fixed_joints,
    "distance_group": _site_distance_group,
    "attachments": _site_attachments,
    "conormal_manifolds": _site_conormal_manifolds,
}


def _einsum_f64(spec, *operands, precision=None):
    del precision
    out = np.einsum(spec, *(np.asarray(o, np.float64) for o in operands))
    return jnp.asarray(out, jnp.float32)


@pytest.mark.parametrize("site", sorted(SITES))
def test_contraction_precision_highest(site, monkeypatch):
    run = SITES[site](jax.random.PRNGKey(0))
    dots = [e for e in jax.make_jaxpr(run)().jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots, f"{site}: no contraction traced"
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2, (site, e.params["precision"])

    got = run()
    monkeypatch.setattr(xpbd, "_einsum", _einsum_f64)
    want = run()
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
