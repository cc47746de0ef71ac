"""Self-collision fidelity/throughput sweep (resolves the COVERAGE.md
'pending a sweep' note): cloth_hanging collection env-steps/s with
self_collision off/on under both solver paths, plus a physics sanity probe
(min inter-particle distance with/without the pass)."""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp

from geometry_rl_tpu.rl import gaussian as G
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_init, obs_norm_step
from geometry_rl_tpu.train import TrainConfig
from geometry_rl_tpu.train.builders import build_agent

NUM_ENVS, STEPS = 256, 50


def bench(self_collision, solver):
    trainer = build_agent(
        task="cloth_hanging", model="hepi", num_envs=NUM_ENVS,
        latent_dim=64, num_ori=16,
        train_cfg=TrainConfig(steps_per_batch=STEPS, mini_batch_size=1000),
        env_kwargs={"warmup_steps": 0, "self_collision": self_collision,
                    "use_pallas_solver": solver},
        dtype=jnp.bfloat16,
    )
    env = trainer.env
    key = jax.random.PRNGKey(0)
    env_state = env.reset(key)
    obs = env.observe(env_state)
    norm = obs_norm_init(env.obs_spec.group_dim("scalars"))
    _, tobs = obs_norm_step(norm, obs, update=False)
    params = trainer.policy.init(key, *trainer.policy_builder.build(tobs))

    @jax.jit
    def collect(env_state, obs, norm, key):
        def step(carry, _):
            env_state, obs, norm, key = carry
            key, k = jax.random.split(key)
            norm, tobs = obs_norm_step(norm, obs, update=True)
            graph, feats = trainer.policy_builder.build(tobs)
            dist = trainer.policy.apply(params, graph, feats)
            action = G.sample(k, dist)
            env_state, ts = env.step(env_state, action)
            return (env_state, ts.obs, norm, key), ts.reward
        carry, r = jax.lax.scan(step, (env_state, obs, norm, key), None, length=STEPS)
        return carry, r.sum()

    out = collect(env_state, obs, norm, key)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(3):
        out = collect(env_state, obs, norm, key)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 3
    (env_state2, *_), _ = out

    # physics probe: min pairwise distance among active (non-hole) particles
    # of env 0 after 50 policy-driven steps
    pos = env_state2.scene.particles.pos[0]  # [P, 3]
    act = getattr(env, "hole_mask", None)
    if act is not None and act.ndim == 2:  # per-env [B, P]
        act = act[0]
    d = jnp.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    d = d + jnp.eye(d.shape[0]) * 1e9
    if act is not None:
        m = (1.0 - act)[:, None] * (1.0 - act)[None, :]
        d = jnp.where(m > 0.5, d, 1e9)
    return STEPS * NUM_ENVS / dt, float(d.min())


# the fused kernel has no self-collision pass: self_collision=True runs the XLA solver
for sc, solver in [(False, "auto"), (False, False), (True, False)]:
    try:
        sps, dmin = bench(sc, solver)
        print(f"self_collision={sc!s:5} solver={solver!s:5}: {sps:10,.0f} steps/s  min_dist={dmin:.4f}", flush=True)
    except Exception as e:
        print(f"self_collision={sc!s:5} solver={solver!s:5}: FAILED {type(e).__name__}: {e}", flush=True)
