"""Sharding-layer tests on the virtual 8-device CPU mesh (conftest.py).

Validates the framework's DP-over-ICI story (SURVEY.md §2.11): env-batched
leaves sharded on the "env" mesh axis, parameters/optimizer/normalizer
replicated, and — the property the design promises — that sharding the env
axis over N devices is semantically a no-op: one `train_iteration` on a
1-device mesh and an 8-device mesh produce the same params and metrics.
"""

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from geometry_rl_tpu.parallel import (
    ENV_AXIS,
    env_sharding,
    make_mesh,
    replicated,
    shard_env_pytree,
    shard_train_state,
)
from geometry_rl_tpu.train import TrainConfig
from geometry_rl_tpu.train.builders import build_agent

NUM_ENVS = 16


def _make_trainer(num_envs=NUM_ENVS, **kw):
    return build_agent(
        task="rigid_insertion",
        model="hepi",
        num_envs=num_envs,
        latent_dim=16,
        num_ori=4,
        train_cfg=TrainConfig(
            algo="trpl",
            steps_per_batch=4,
            ppo_epochs=2,
            mini_batch_size=2 * num_envs,
            **kw,
        ),
        env_kwargs={"warmup_steps": 0, "episode_length": 4},
    )


@pytest.fixture(scope="module")
def trainer():
    return _make_trainer()


@pytest.fixture(scope="module")
def state(trainer):
    return trainer.init(jax.random.PRNGKey(0))


def _leaves_with_ndim(tree):
    return [x for x in jax.tree_util.tree_leaves(tree) if hasattr(x, "ndim")]


def test_shard_train_state_placement(trainer, state):
    mesh = make_mesh(8)
    sharded = shard_train_state(state, mesh, NUM_ENVS)

    env_spec = P(ENV_AXIS)
    rep_spec = P()

    # env-batched leaves land on the env axis
    for leaf in _leaves_with_ndim(sharded.env_state):
        assert isinstance(leaf.sharding, NamedSharding)
        if leaf.ndim >= 1 and leaf.shape[0] == NUM_ENVS:
            assert leaf.sharding.spec == env_spec, leaf.shape
        else:
            assert leaf.sharding.spec == rep_spec, leaf.shape
    for leaf in _leaves_with_ndim(sharded.obs):
        assert leaf.sharding.spec == env_spec

    # params / optimizer / normalizer / counters replicated
    for tree in (
        sharded.actor_params,
        sharded.critic_params,
        sharded.actor_opt,
        sharded.critic_opt,
        sharded.norm,
    ):
        for leaf in _leaves_with_ndim(tree):
            assert leaf.sharding.spec == rep_spec, leaf.shape
    assert sharded.num_updates.sharding.spec == rep_spec


def test_shard_env_pytree_helpers():
    mesh = make_mesh(8)
    tree = {
        "batched": jnp.zeros((NUM_ENVS, 3)),
        "scalar": jnp.zeros(()),
        "nonbatched": jnp.zeros((7, 3)),
    }
    out = shard_env_pytree(tree, mesh, NUM_ENVS)
    assert out["batched"].sharding == env_sharding(mesh)
    assert out["scalar"].sharding == replicated(mesh)
    assert out["nonbatched"].sharding == replicated(mesh)


def test_shard_env_pytree_never_shards_prng_keys():
    """With num_envs == 2 a raw PRNG key is uint32[2] and shape-matches the
    env axis; the name-based guard must keep it replicated (sharding a key
    across devices silently changes RNG semantics)."""
    import collections

    mesh = make_mesh(2)
    State = collections.namedtuple("State", ["key", "obs"])
    tree = State(key=jax.random.PRNGKey(0), obs=jnp.zeros((2, 3)))
    out = shard_env_pytree(tree, mesh, num_envs=2)
    assert out.key.sharding == replicated(mesh)
    assert out.obs.sharding == env_sharding(mesh)
    # dict containers use DictKey paths; same guard applies
    out2 = shard_env_pytree({"key": jax.random.PRNGKey(1), "x": jnp.zeros((2,))}, mesh, 2)
    assert out2["key"].sharding == replicated(mesh)
    assert out2["x"].sharding == env_sharding(mesh)


def test_train_iteration_under_mesh_finite(trainer, state):
    mesh = make_mesh(8)
    sharded = shard_train_state(state, mesh, NUM_ENVS)
    with mesh:
        new_state, metrics = trainer.train_iteration(sharded)
        jax.block_until_ready(metrics)
    for k, v in metrics.items():
        if k == "train/reward":
            continue  # NaN until the first episode completes
        assert jnp.isfinite(v), (k, v)
    # params actually changed and stayed finite
    for leaf in _leaves_with_ndim(new_state.actor_params):
        assert jnp.all(jnp.isfinite(leaf))


def test_one_vs_eight_device_equivalence(trainer, state):
    """DP over the env axis must be semantically a no-op: identical seed,
    identical program → same result on 1 and 8 devices (up to reduction
    order)."""
    mesh1 = make_mesh(1)
    mesh8 = make_mesh(8)

    s1 = shard_train_state(state, mesh1, NUM_ENVS)
    s8 = shard_train_state(state, mesh8, NUM_ENVS)

    with mesh1:
        out1, m1 = trainer.train_iteration(s1)
        jax.block_until_ready(m1)
    with mesh8:
        out8, m8 = trainer.train_iteration(s8)
        jax.block_until_ready(m8)

    for k in m1:
        a, b = float(m1[k]), float(m8[k])
        if jnp.isnan(a) and jnp.isnan(b):
            continue
        assert abs(a - b) <= 1e-4 + 1e-3 * abs(a), (k, a, b)

    import numpy as np

    flat1 = jax.tree_util.tree_leaves(out1.actor_params)
    flat8 = jax.tree_util.tree_leaves(out8.actor_params)
    for a, b in zip(flat1, flat8):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=5e-5, rtol=1e-4), (a.shape,)
    # env state (positions etc.) identical too
    for a, b in zip(
        jax.tree_util.tree_leaves(out1.env_state), jax.tree_util.tree_leaves(out8.env_state)
    ):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_papi_iteration_under_mesh_finite():
    """The PAPI post-update path (history scan + weight interpolation over
    full-batch forwards) must also run under the env-sharded mesh."""
    trainer = build_agent(
        task="rigid_pushing",
        model="mlp",
        num_envs=NUM_ENVS,
        algo="trpl",
        latent_dim=8,
        proj_type="papi",
        contextual_std=False,
        train_cfg=TrainConfig(
            algo="trpl", steps_per_batch=4, ppo_epochs=2, mini_batch_size=2 * NUM_ENVS,
            papi_steps=True, papi_history=2, papi_iters=2,
        ),
        env_kwargs={"warmup_steps": 0, "episode_length": 4},
    )
    state = trainer.init(jax.random.PRNGKey(0))
    papi_state = trainer.papi_init(state)
    mesh = make_mesh(8)
    sharded = shard_train_state(state, mesh, NUM_ENVS)
    with mesh:
        new_state, papi_state, metrics = trainer.train_iteration_papi(sharded, papi_state)
        jax.block_until_ready(metrics)
    assert jnp.isfinite(metrics["loss_objective"])
    assert jnp.isfinite(metrics["papi/n_backtracks"])
    for leaf in _leaves_with_ndim(new_state.actor_params):
        assert jnp.all(jnp.isfinite(leaf))


def test_cloth_env_step_under_mesh():
    """Particle pytrees (SceneState.particles) shard and step correctly under
    the env mesh — the rigid-only coverage above never touches them."""
    from geometry_rl_tpu.envs import make_env

    env = make_env("cloth_hanging", num_envs=16, warmup_steps=0, episode_length=4)
    mesh = make_mesh(8)
    state = env.reset(jax.random.PRNGKey(0))
    state = shard_env_pytree(state, mesh, 16)
    assert state.scene.particles.pos.sharding == env_sharding(mesh)
    assert state.key.sharding == replicated(mesh)

    step = jax.jit(env.step)
    a = jnp.zeros((16, env.cfg.action_dim))
    for _ in range(3):
        state, ts = step(state, a)
    assert jnp.isfinite(ts.reward).all()
    assert jnp.isfinite(state.scene.particles.pos).all()
    # env-sharded layout survives the jitted step (no silent gather)
    spec = state.scene.particles.pos.sharding.spec
    assert spec and spec[0] == ENV_AXIS, spec


def test_minibatch_gradient_one_vs_eight_devices():
    """The gradient of one minibatch sharded over 8 devices equals the
    one-device gradient up to the order of the f32 sums (chip_smoke.py
    --four-cards runs the same check at flagship width on 4 cards)."""
    import chip_smoke

    small = {"env": {"num_envs": 16}, "algorithm": {"dtype": "float32", "latent_dim": 8, "num_ori": 4}}
    assert chip_smoke.minibatch_gradient_diff(small, 8) <= chip_smoke.GRAD_RTOL
