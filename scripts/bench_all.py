import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
"""All-task benchmark table: env-only stepping and full collection (policy +
physics + obs pipeline) throughput per task. Writes docs/bench_all.json."""
import json
import time

import jax
import jax.numpy as jnp

from geometry_rl_tpu.envs import make_env
from geometry_rl_tpu.rl import gaussian as G
from geometry_rl_tpu.rl.obs_pipeline import obs_norm_init, obs_norm_step
from geometry_rl_tpu.train import TrainConfig
from geometry_rl_tpu.train.builders import build_agent

STEPS = 50
TASKS = [
    ("rigid_insertion", 1024, {}),
    ("rigid_pushing", 1024, {}),
    ("rigid_sliding", 1024, {}),
    ("rigid_insertion_two_agents", 1024, {}),
    ("rope_closing", 512, {}),
    ("rope_shaping", 256, {}),
    ("cloth_hanging_xla", 256, {"use_pallas_solver": False}),
    ("cloth_hanging", 256, {}),  # fused kernel on a GPU
]


def timeit(f, *args, n=3):
    out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def bench_env_only(task, B, kwargs):
    env = make_env(task, num_envs=B, **kwargs)
    state = env.reset(jax.random.PRNGKey(0))
    A = env.cfg.action_dim

    @jax.jit
    def run(state, key):
        def step(carry, _):
            state, key = carry
            key, k = jax.random.split(key)
            a = jax.random.uniform(k, (B, A), minval=-1, maxval=1)
            state, ts = env.step(state, a)
            return (state, key), ts.reward

        carry, r = jax.lax.scan(step, (state, key), None, length=STEPS)
        return carry, r.sum()

    dt = timeit(run, state, jax.random.PRNGKey(1))
    return STEPS * B / dt


def bench_collection(task, B, kwargs):
    trainer = build_agent(
        task=task.replace("_xla", ""),
        model="hepi",
        num_envs=B,
        latent_dim=64,
        num_ori=16,
        train_cfg=TrainConfig(steps_per_batch=STEPS, mini_batch_size=1000),
        env_kwargs=kwargs,
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

    dt = timeit(collect, env_state, obs, norm, key)
    return STEPS * B / dt


def main():
    results = {}
    for task, B, kwargs in TASKS:
        base_task = task.replace("_xla", "")
        try:
            env_rate = bench_env_only(base_task, B, kwargs)
            results[task] = {"num_envs": B, "env_only_steps_per_s": round(env_rate, 1)}
            if task in ("rigid_insertion", "cloth_hanging", "cloth_hanging_xla", "rope_closing"):
                coll = bench_collection(task, B, kwargs)
                results[task]["collection_steps_per_s"] = round(coll, 1)
        except Exception as e:  # keep going; report failures
            results[task] = {"error": f"{type(e).__name__}: {e}"}
        print(task, "->", json.dumps(results[task]), flush=True)

    out = _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), "docs", "bench_all.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
