"""Golden-trajectory regression gates for the simulator.

The driver's fidelity gate compares trajectories across versions (BASELINE.md:
"physics fidelity gated vs reference trajectories"). The reference's PhysX
trajectories are unavailable (Isaac Sim is not in this environment), so the
gate is self-referential: deterministic rollouts of each task family are
recorded once (tests/golden/*.npz) and every future change must reproduce
them within tolerance — catching silent physics regressions exactly the way
the reference gate would.

Regenerate intentionally with:  python tests/test_golden_trajectories.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometry_rl_tpu.envs import make_env

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# warmup_steps=0 everywhere: the gate checks SOLVER behavior; reset-time
# warmup is MDP policy and changes with reference parity, not physics
CASES = {
    "rigid_insertion": dict(num_envs=2, warmup_steps=0),
    "rigid_pushing": dict(num_envs=2, warmup_steps=0),
    "rigid_sliding": dict(num_envs=2, warmup_steps=0),
    "rigid_insertion_two_agents": dict(num_envs=2, warmup_steps=0),
    "rope_closing": dict(num_envs=2, num_links=20, rope_length=2.5, warmup_steps=0),
    "rope_shaping": dict(num_envs=2, num_links=20, rope_length=2.5, warmup_steps=0),
    "cloth_hanging": dict(num_envs=2, warmup_steps=0),
}
N_STEPS = 20


def rollout_positions(task: str, kwargs) -> np.ndarray:
    env = make_env(task, **kwargs)
    state = env.reset(jax.random.PRNGKey(123))
    A = env.cfg.action_dim
    B = env.cfg.num_envs
    frames = []
    for t in range(N_STEPS):
        # deterministic quasi-random actions
        action = jnp.sin(jnp.arange(B * A, dtype=jnp.float32).reshape(B, A) * 0.7 + t * 0.3)
        state, _ = env.step(state, action)
        bodies = np.asarray(state.scene.bodies.pos).reshape(B, -1)
        if state.scene.particles is not None:
            parts = np.asarray(state.scene.particles.pos).reshape(B, -1)
            frames.append(np.concatenate([bodies, parts], axis=-1))
        else:
            frames.append(bodies)
    return np.stack(frames)  # [T, B, D]


@pytest.mark.parametrize("task", sorted(CASES))
def test_golden_trajectory(task):
    path = os.path.join(GOLDEN_DIR, f"{task}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden file missing — run this module as a script to generate {path}")
    golden = np.load(path)["traj"]
    traj = rollout_positions(task, CASES[task])
    assert traj.shape == golden.shape, (traj.shape, golden.shape)
    np.testing.assert_allclose(traj, golden, atol=5e-3, rtol=1e-3)


def test_pallas_solver_cross_gate_128_envs():
    """Solver cross-gate at flagship-like batch: the fused cloth kernel
    (interpret mode on CPU) must reproduce the XLA solver's trajectory at
    128 envs — the small-batch parity tests in test_envs_cloth.py miss
    indexing bugs that only appear when the grid spans many envs."""
    B, steps = 128, 6
    env = make_env("cloth_hanging", num_envs=B, warmup_steps=0, use_pallas_solver=False)
    state = env.reset(jax.random.PRNGKey(7))
    A = env.cfg.action_dim
    for t in range(steps):
        action = jnp.sin(jnp.arange(B * A, dtype=jnp.float32).reshape(B, A) * 0.7 + t * 0.3)
        pre = env._apply_action(state.scene, action)
        sx = env._physics(pre, state.hanger_pos)
        # both solvers advance the SAME state each step (f32 accumulation-
        # order noise amplifies ~3x/step through cloth contact if left
        # free-running, so a trajectory-endpoint compare would gate chaos,
        # not the solver)
        sp = env._physics_pallas(pre, state.hanger_pos, interpret=True)
        np.testing.assert_allclose(
            np.asarray(sp.particles.pos), np.asarray(sx.particles.pos), atol=2e-4
        )
        np.testing.assert_allclose(
            np.asarray(sp.bodies.pos), np.asarray(sx.bodies.pos), atol=2e-4
        )
        state = state._replace(scene=sx)


@pytest.mark.gpu
def test_cloth_kernel_compiled_matches_xla(gpu):
    """The compiled kernel on the card against the XLA solver at 256 envs
    (chip_smoke.py runs the same check)."""
    import chip_smoke

    worst = chip_smoke.cloth_kernel_parity(num_envs=256)
    assert max(worst.values()) <= chip_smoke.CLOTH_ATOL, worst


if __name__ == "__main__":
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for task, kwargs in CASES.items():
        traj = rollout_positions(task, kwargs)
        np.savez_compressed(os.path.join(GOLDEN_DIR, f"{task}.npz"), traj=traj)
        print(f"wrote golden/{task}.npz {traj.shape}")
