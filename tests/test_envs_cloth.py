"""Cloth hanging environment + graph builder + trainer tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometry_rl_tpu.envs import make_env
from geometry_rl_tpu.envs.cloth import (
    K_BOUNDARY,
    N_PARTICLES,
    N_ROW,
    build_hole_variant,
    sample_hole_placements,
)
from geometry_rl_tpu.graphs.cloth import ClothGraphBuilder
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply, obs_norm_init
from geometry_rl_tpu.train import TrainConfig
from geometry_rl_tpu.train.builders import build_agent

B = 4


def test_hole_placements_deterministic():
    p1 = sample_hole_placements()
    p2 = sample_hole_placements()
    assert p1 == p2
    assert len(p1) == 40
    assert len(set(p1)) == 40


def test_hole_variant():
    removed, boundary = build_hole_variant((7, 7))
    # plus-shaped cutout: center + 4 neighbors (radius 1.1 grid units)
    assert removed.sum() == 5
    assert len(boundary) == K_BOUNDARY
    # boundary nodes not removed
    assert (removed[boundary] == 0).all()
    # boundary nodes near the hole center
    r, c = boundary // N_ROW, boundary % N_ROW
    d = np.sqrt((r - 7) ** 2 + (c - 7) ** 2)
    assert d.max() <= 2.5


@pytest.fixture(scope="module")
def env():
    return make_env("cloth_hanging", num_envs=B)


def test_cloth_env_steps(env):
    state = env.reset(jax.random.PRNGKey(0))
    assert state.scene.particles.pos.shape == (B, N_PARTICLES, 3)
    state, ts = env.step(state, jnp.zeros((B, env.cfg.action_dim)))
    assert np.isfinite(np.asarray(ts.reward)).all()
    for g in ("scalars", "position_vectors", "velocity_vectors", "infos"):
        assert ts.obs[g].shape == (B, env.obs_spec.group_dim(g)), g


def test_cloth_corners_attached(env):
    state = env.reset(jax.random.PRNGKey(1))
    action = jnp.zeros((B, 12)).at[:, 0].set(0.5)  # move gripper 0 in +x
    for _ in range(20):
        state, _ = env.step(state, action)
        state = state._replace(episode_step=jnp.zeros_like(state.episode_step))
    corners = np.asarray(state.scene.particles.pos[:, np.asarray(env.corner_indices)])
    cubes = np.asarray(state.scene.bodies.pos)
    d = np.linalg.norm(corners - cubes, axis=-1)
    assert d.max() < 0.05


def test_cloth_holds_shape_under_gravity(env):
    """Stretch constraints keep the sheet from tearing apart while the corner
    pins hold it up."""
    state = env.reset(jax.random.PRNGKey(2))
    for _ in range(40):
        state, _ = env.step(state, jnp.zeros((B, 12)))
        state = state._replace(episode_step=jnp.zeros_like(state.episode_step))
    parts = np.asarray(state.scene.particles.pos)
    hole = np.asarray(env.hole_mask) > 0.5
    # valid particles stay within a sane bounding volume around the corners
    for b in range(B):
        valid = parts[b][~hole[b]]
        span = valid.max(0) - valid.min(0)
        assert span.max() < 2.0, span  # 1m cloth cannot stretch to 2m


def test_hole_particles_frozen(env):
    """Removed (hole) particles have zero inverse mass — they never move."""
    state = env.reset(jax.random.PRNGKey(3))
    p0 = np.asarray(state.scene.particles.pos)
    for _ in range(10):
        state, _ = env.step(state, jnp.zeros((B, 12)))
        state = state._replace(episode_step=jnp.zeros_like(state.episode_step))
    p1 = np.asarray(state.scene.particles.pos)
    hole = np.asarray(env.hole_mask) > 0.5
    moved = np.linalg.norm(p1 - p0, axis=-1)
    assert moved[hole].max() < 1e-5


def test_cloth_graph_builders(env):
    state = env.reset(jax.random.PRNGKey(4))
    obs = env.observe(state)
    norm = obs_norm_init(env.obs_spec.group_dim("scalars"))
    tobs = obs_norm_apply(norm, obs)

    policy_builder = ClothGraphBuilder.from_env(env, dist_as_pos=True, full_graph_obs=False)
    g, f = policy_builder.build(tobs)
    assert set(g.nodes) == {"grippers", "hole_boundary"}
    assert f.scalars["grippers"].shape == (B, 4, 4)  # one-hot dim 4

    critic_builder = ClothGraphBuilder.from_env(env, dist_as_pos=False, full_graph_obs=True)
    g2, f2 = critic_builder.build(tobs)
    assert "particles" in g2.nodes
    assert g2.nodes["particles"].mask is not None


def test_cloth_trainer_end_to_end():
    trainer = build_agent(
        task="cloth_hanging",
        model="hepi",
        num_envs=2,
        algo="trpl",
        latent_dim=16,
        num_ori=4,
        train_cfg=TrainConfig(algo="trpl", steps_per_batch=4, ppo_epochs=1, mini_batch_size=8),
        env_kwargs={"episode_length": 4},
    )
    state = trainer.init(jax.random.PRNGKey(0))
    state, metrics = trainer.train_iteration(state)
    assert np.isfinite(float(metrics["loss_objective"]))
    assert np.isfinite(float(metrics["loss_critic"]))


def test_hole_train_test_split_disjoint():
    train = make_env("cloth_hanging", num_envs=2, hole_split="train")
    test = make_env("cloth_hanging", num_envs=2, hole_split="test")
    # different hole variants => different removed-particle masks somewhere
    assert not np.array_equal(np.asarray(train.hole_mask), np.asarray(test.hole_mask))


def test_object_target_distance_info(env):
    import jax
    import jax.numpy as jnp
    import numpy as np

    state = env.reset(jax.random.PRNGKey(0))
    state, ts = env.step(state, jnp.zeros((env.cfg.num_envs, env.cfg.action_dim)))
    d = np.asarray(ts.info["object_target_distance"])
    assert d.shape == (env.cfg.num_envs,)
    assert np.isfinite(d).all() and (d > 0).all()


def test_pallas_tiled_solver_matches_xla():
    """The fused position-solve kernel (Pallas, Triton route; interpret mode
    on CPU) reproduces the XLA solver trajectory."""
    env = make_env("cloth_hanging", num_envs=2, warmup_steps=0, use_pallas_solver=False)
    state_x = env.reset(jax.random.PRNGKey(11))
    state_p = env.reset(jax.random.PRNGKey(11))

    action = jnp.ones((2, 12)) * 0.3
    for _ in range(5):
        sx = env._physics(env._apply_action(state_x.scene, action), state_x.hanger_pos)
        sp = env._physics_pallas(
            env._apply_action(state_p.scene, action), state_p.hanger_pos, interpret=True
        )
        state_x = state_x._replace(scene=sx)
        state_p = state_p._replace(scene=sp)
        np.testing.assert_allclose(
            np.asarray(state_x.scene.particles.pos),
            np.asarray(state_p.scene.particles.pos),
            atol=2e-4,
        )
        np.testing.assert_allclose(
            np.asarray(state_x.scene.bodies.pos),
            np.asarray(state_p.scene.bodies.pos),
            atol=2e-4,
        )


@pytest.mark.parametrize("num_envs", [4, 16])
def test_cloth_kernel_matches_xla_per_step(num_envs):
    """From the same states, one env step of the kernel (interpret mode)
    against the XLA solver, with per-env hole variants and actions."""
    env = make_env("cloth_hanging", num_envs=num_envs, warmup_steps=0, use_pallas_solver=False)
    state = env.reset(jax.random.PRNGKey(3))
    A = env.cfg.action_dim
    for t in range(2):
        action = jnp.sin(jnp.arange(num_envs * A, dtype=jnp.float32).reshape(num_envs, A) * 0.7 + t)
        pre = env._apply_action(state.scene, action)
        sx = env._physics(pre, state.hanger_pos)
        sp = env._physics_pallas(pre, state.hanger_pos, interpret=True)
        np.testing.assert_allclose(np.asarray(sp.particles.pos), np.asarray(sx.particles.pos), atol=2e-4)
        np.testing.assert_allclose(np.asarray(sp.bodies.pos), np.asarray(sx.bodies.pos), atol=2e-4)
        state = state._replace(scene=sx)


def test_pack_groups_pads_to_spare_row():
    """Padded constraint lanes point at the spare last row with mask 0."""
    from geometry_rl_tpu.sim.pallas_cloth import kernel_rows, pack_groups

    env = make_env("cloth_hanging", num_envs=3, warmup_steps=0)
    groups = env.distance_groups
    P = env.solve_spec.num_particles + env.solve_spec.num_bodies
    gi, gj, rest, mask = pack_groups(groups, P)
    rows = kernel_rows(P)
    assert rows == 256 and rows > P
    assert gi.shape == gj.shape == rest.shape == (16, 128) and mask.shape == (3, 16, 128)
    for g, grp in enumerate(groups):
        C = grp.i.shape[0]
        np.testing.assert_array_equal(np.asarray(gi[g, :C]), np.asarray(grp.i))
        np.testing.assert_array_equal(np.asarray(mask[:, g, :C]), np.asarray(grp.mask))
        assert (np.asarray(gi[g, C:]) == rows - 1).all() and (np.asarray(gj[g, C:]) == rows - 1).all()
        assert (np.asarray(mask[:, g, C:]) == 0).all()
    assert (np.asarray(gi[len(groups):]) == rows - 1).all()


def test_cloth_action_term_parity():
    """Reference cloth CubeActionTerm: 3-dim per cube, clamp(+-1)*2.0, z kept
    (cloth_tasks/mdp/actions.py:32-36)."""
    env = make_env("cloth_hanging", num_envs=2, warmup_steps=0)
    assert env.cfg.action_dim == 12  # 4 grippers x 3
    state = env.reset(jax.random.PRNGKey(0))
    a = jnp.zeros((2, 12)).at[:, 0].set(3.0).at[:, 5].set(-0.5)
    scene = env._apply_action(state.scene, a)
    v = np.asarray(scene.bodies.lin_vel)
    np.testing.assert_allclose(v[:, 0], [[2.0, 0.0, 0.0]] * 2)  # clamped * 2
    np.testing.assert_allclose(v[:, 1], [[0.0, 0.0, -1.0]] * 2)  # z allowed


def test_cloth_kernel_request_rejects_self_collision():
    """The kernel has no self-collision pass: an explicit request raises and
    "auto" keeps the XLA solver."""
    with pytest.raises(ValueError, match="self_collision"):
        make_env("cloth_hanging", num_envs=2, self_collision=True, use_pallas_solver=True)
    env = make_env("cloth_hanging", num_envs=2, warmup_steps=0, self_collision=True)
    assert env.solver_mode is False


def test_cloth_solver_auto_by_platform(monkeypatch):
    """"auto" is the kernel on a GPU and the XLA solver elsewhere, and the
    XLA solver on a GPU whenever self-collision or the material is on."""
    from geometry_rl_tpu.envs.cloth import ClothEnv, ClothTaskCfg

    assert ClothEnv._choose_solver(ClothTaskCfg()) is False  # CPU here
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ClothEnv._choose_solver(ClothTaskCfg()) is True
    assert ClothEnv._choose_solver(ClothTaskCfg(self_collision=True)) is False
    assert ClothEnv._choose_solver(ClothTaskCfg(restitution=0.2)) is False
    assert ClothEnv._choose_solver(ClothTaskCfg(use_pallas_solver=False)) is False


def test_cloth_material_steers_solver_and_plumbs():
    """Material on: 'auto' resolves to the XLA solver (the velocity pass is
    XLA-only), an explicit kernel request raises, and the hook contact
    carries the coefficients."""
    import pytest

    from geometry_rl_tpu.envs import make_env

    env = make_env("cloth_hanging", num_envs=2, warmup_steps=0,
                   dynamic_friction_scale=1.0, restitution=0.2)
    assert env.solver_mode is False
    (c,) = env._hanger_contacts(env.reset(jax.random.PRNGKey(0)).scene.bodies.pos[:, 0])
    assert c.restitution == 0.2 and c.dynamic_friction == c.friction
    with pytest.raises(ValueError, match="velocity-pass material"):
        make_env("cloth_hanging", num_envs=2, use_pallas_solver=True,
                 dynamic_friction_scale=1.0)
