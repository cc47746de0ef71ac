"""Benchmark: collection throughput and one full train iteration, as one
JSON line.

Headline metric: rigid_insertion HEPi collection throughput (env-steps/sec)
— what the reference's `sampling_time` covers (train.py:232). The `extra`
field carries:

- cloth_hanging collection env-steps/sec;
- rigid_insertion FULL train_iteration (collect + GAE + 5 PPO epochs) —
  wall-time per iteration and end-to-end frames/sec at reference scale
  (the reference's sampling_time + training_time);
- rough MFU of the train_iteration, from XLA's compiled-flops estimate
  divided by (wall-time x the card's peak bf16 FLOP/s);
- the card's name and power limit (nvidia-smi).

Needs a GPU. Set GEOMRL_BENCH_TINY=1 for a fast CPU smoke run of the harness
itself (tiny shapes, no MFU).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"""

import json
import os
import subprocess
import time

import jax
import jax.numpy as jnp

BASELINE = 50_000.0  # env-steps/sec reference point (BASELINE.md)
TINY = os.environ.get("GEOMRL_BENCH_TINY") == "1"

# Dense bf16 peak FLOP/s per card, keyed by exact `device_kind`.
# Source: NVIDIA H100 data sheet (SXM, without sparsity), at the 700 W limit.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device_kind: str) -> float:
    """Peak bf16 FLOP/s of `device_kind`; an unknown device is an error."""
    try:
        return PEAK_FLOPS[device_kind]
    except KeyError:
        raise ValueError(f"no peak FLOP/s on record for device kind {device_kind!r}") from None


def card_name_and_power_limit() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _shard(trainer, env_state, obs, norm, params, num_envs):
    """Shard the env axis over every available device (no-op on one chip)."""
    n_dev = len(jax.devices())
    if n_dev > 1 and num_envs % n_dev == 0:
        from geometry_rl_tpu.parallel import make_mesh, replicated, shard_env_pytree

        mesh = make_mesh()
        env_state = shard_env_pytree(env_state, mesh, num_envs)
        obs = shard_env_pytree(obs, mesh, num_envs)
        norm = jax.device_put(norm, replicated(mesh))
        params = jax.device_put(params, replicated(mesh))
    return env_state, obs, norm, params


def bench_collection(task, num_envs, scan_steps, n_runs=3, env_kwargs=None):
    """env-steps/sec of the jitted collection loop (physics + obs pipeline +
    graph build + HEPi forward + sampling)."""
    from geometry_rl_tpu.rl import gaussian as G
    from geometry_rl_tpu.rl.obs_pipeline import obs_norm_init, obs_norm_step
    from geometry_rl_tpu.train import TrainConfig
    from geometry_rl_tpu.train.builders import build_agent

    trainer = build_agent(
        task=task,
        model="hepi",
        num_envs=num_envs,
        latent_dim=16 if TINY else 64,
        num_ori=4 if TINY else 16,
        train_cfg=TrainConfig(steps_per_batch=scan_steps, mini_batch_size=1000),
        env_kwargs={"warmup_steps": 0, **(env_kwargs or {})},
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

        (env_state, obs, norm, key), rewards = jax.lax.scan(
            step, (env_state, obs, norm, key), None, length=scan_steps
        )
        return env_state, obs, norm, key, rewards.sum()

    env_state, obs, norm, params = _shard(trainer, env_state, obs, norm, params, num_envs)

    out = collect(env_state, obs, norm, key)  # warmup/compile
    jax.block_until_ready(out)
    env_state, obs, norm, key = out[:4]

    t0 = time.perf_counter()
    for _ in range(n_runs):
        out = collect(env_state, obs, norm, key)
        env_state, obs, norm, key = out[:4]
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return n_runs * scan_steps * num_envs / dt


def _iteration_flops(trainer, state, steps, num_envs):
    """XLA's flop estimate of one train_iteration, or None if unavailable.

    XLA cost_analysis() counts each lax.scan / while body ONCE, so lowering
    the whole train_iteration under-reports by the trip counts (~500x here).
    Instead lower the two loop bodies — one minibatch grad step and one
    collection program — and multiply by their trip counts (epochs x
    n_minibatches, and 1: collect is lowered whole, its T-step scan body
    again counted once, so scale by T)."""
    try:
        import jax.tree_util as jtu

        def _flops_of(lowered):
            cost = lowered.compile().cost_analysis()
            if not cost:
                return 0.0
            cost = cost[0] if isinstance(cost, (list, tuple)) else cost
            return float(cost.get("flops", 0.0))

        _, batch, _ = jax.jit(trainer._collect)(state)
        T, B = steps, num_envs
        fl = lambda x: x.reshape((T * B,) + x.shape[2:])
        mbs = trainer.mini_batch_size
        mb = {
            "tobs": jtu.tree_map(lambda x: fl(x)[:mbs], batch.tobs),
            "action": fl(batch.action)[:mbs],
            "log_prob": fl(batch.log_prob)[:mbs],
            "mean": fl(batch.mean)[:mbs],
            "std": fl(batch.std)[:mbs],
            "value": fl(batch.value)[:mbs],
            "advantage": fl(batch.value)[:mbs],
            "value_target": fl(batch.value)[:mbs],
            "env_ids": jnp.tile(jnp.arange(B, dtype=jnp.int32), T)[:mbs],
        }
        grad_fn = jax.jit(jax.grad(trainer._minibatch_loss, argnums=(0, 1), has_aux=True))
        grad_flops = _flops_of(
            grad_fn.lower(state.actor_params, state.critic_params, mb, state.num_updates, state.initial_entropy)
        )
        collect_flops = _flops_of(jax.jit(trainer._collect).lower(state)) * steps
        n_updates = trainer.cfg.ppo_epochs * trainer.num_minibatches
        return grad_flops * n_updates + collect_flops
    except Exception:
        return None


def bench_train_iteration(task="rigid_insertion", num_envs=1024, steps=100, n_runs=2, peak=None):
    """Wall-time + frames/sec + rough MFU (against `peak` FLOP/s per device,
    when given) of the FULL jitted train_iteration (collect -> GAE -> 5 PPO
    epochs) at reference scale."""
    from geometry_rl_tpu.train import TrainConfig
    from geometry_rl_tpu.train.builders import build_agent

    trainer = build_agent(
        task=task,
        model="hepi",
        num_envs=num_envs,
        latent_dim=16 if TINY else 64,
        num_ori=4 if TINY else 16,
        train_cfg=TrainConfig(steps_per_batch=steps, ppo_epochs=5, mini_batch_size=1000),
        env_kwargs={"warmup_steps": 0},
        dtype=jnp.bfloat16,
    )
    state = trainer.init(jax.random.PRNGKey(0))

    # shard the env axis over all chips (as bench_collection does) so the
    # measured iteration actually uses every device the MFU denominator
    # divides by
    mesh = None
    n_dev = len(jax.devices())
    if n_dev > 1 and num_envs % n_dev == 0:
        from geometry_rl_tpu.parallel import make_mesh, shard_train_state

        mesh = make_mesh(n_dev)
        state = shard_train_state(state, mesh, num_envs)

    step_fn = jax.jit(lambda s: trainer.train_iteration(s))
    flops = _iteration_flops(trainer, state, steps, num_envs) if peak is not None else None

    import contextlib

    with mesh if mesh is not None else contextlib.nullcontext():
        state, _ = step_fn(state)  # warmup/compile
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(n_runs):
            state, metrics = step_fn(state)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / n_runs

    frames = steps * num_envs
    result = {"iteration_s": round(dt, 3), "frames_per_sec": round(frames / dt, 1)}
    if flops and peak:
        # denominator = the chips the iteration actually ran on
        used = n_dev if mesh is not None else 1
        result["mfu"] = round(flops / dt / (peak * used), 5)
        result["xla_flops_per_iter"] = flops
    return result


def main():
    from geometry_rl_tpu.xla_config import configure_xla

    configure_xla()
    device = jax.devices()[0]
    if TINY:
        card = "not measured (CPU harness smoke)"
        rigid = bench_collection("rigid_insertion", 8, 4, n_runs=1)
        cloth = bench_collection("cloth_hanging", 8, 4, n_runs=1)
        update = bench_train_iteration(num_envs=8, steps=4, n_runs=1)
    else:
        if device.platform != "gpu":
            raise SystemExit(f"bench.py measures a GPU; JAX found {device.platform!r}")
        card = card_name_and_power_limit()
        rigid = bench_collection("rigid_insertion", 1024, 50)
        cloth = bench_collection("cloth_hanging", 256, 50)
        update = bench_train_iteration(num_envs=1024, steps=100, peak=peak_flops(device.device_kind))

    print(
        json.dumps(
            {
                "metric": "rigid_insertion_hepi_collection_env_steps_per_sec",
                "value": round(rigid, 1),
                "unit": "env-steps/sec",
                "vs_baseline": round(rigid / BASELINE, 3),
                "extra": {
                    "cloth_hanging_collection_env_steps_per_sec": round(cloth, 1),
                    "cloth_vs_baseline": round(cloth / BASELINE, 3),
                    "rigid_insertion_train_iteration": update,
                    "n_devices": len(jax.devices()),
                    "platform": device.platform,
                    "device_kind": device.device_kind,
                    "card_name_power_limit": card,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
