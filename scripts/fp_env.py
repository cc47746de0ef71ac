"""Cloth env behavioral fingerprint (CPU, no model).

Round-5 cloth-regression bisect tool: runs a deterministic fixed-action
rollout of cloth_hanging and prints high-precision trajectory fingerprints.
Run the same file under different git worktrees (PYTHONPATH switch) and
diff the output: identical numbers => env/sim semantics unchanged between
versions; material differences => the commit changed physics/obs/reward.

Usage: JAX_PLATFORMS=cpu python scripts/fp_env.py [--steps 100] [--envs 8]
"""

import argparse
import os
import sys

# resolve geometry_rl_tpu from THIS script's repo/worktree
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Default is CPU; `--platform default` uses JAX's default backend (a GPU runs
# the fused cloth kernel, solver_mode True, which the CPU run cannot reach).
if "--platform" in sys.argv:
    _plat = sys.argv[sys.argv.index("--platform") + 1]
else:
    _plat = "cpu"
if _plat != "default":
    jax.config.update("jax_platforms", _plat)

import jax.numpy as jnp
import numpy as np


def fp(name, arr):
    a = np.asarray(jax.device_get(arr), dtype=np.float64)
    print(
        f"FP {name}: sum={a.sum():.10e} abs={np.abs(a).sum():.10e} "
        f"min={a.min():.10e} max={a.max():.10e} shape={a.shape}"
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="cpu", help="cpu (default) or 'default' for JAX's default backend")
    args = p.parse_args()
    print("backend:", jax.default_backend())

    from geometry_rl_tpu.envs import make_env

    env = make_env("cloth_hanging", num_envs=args.envs)
    print("solver_mode:", getattr(env, "solver_mode", "<none>"))
    key = jax.random.PRNGKey(args.seed)
    state = env.reset(key)

    fp("reset.particles", state.scene.particles.pos)
    obs0 = env.observe(state)
    for g in sorted(obs0):
        fp(f"reset.obs.{g}", obs0[g])

    adim = env.cfg.action_dim if hasattr(env.cfg, "action_dim") else None
    # probe action dim from a zero step if cfg doesn't expose it
    if adim is None:
        adim = env.action_dim

    step = jax.jit(env.step)

    t = jnp.arange(args.steps, dtype=jnp.float32)
    rewards = []
    for i in range(args.steps):
        # deterministic, env- and dim-varying actions in [-1, 1]
        act = jnp.sin(
            0.37 * i
            + 0.61 * jnp.arange(args.envs, dtype=jnp.float32)[:, None]
            + 0.13 * jnp.arange(adim, dtype=jnp.float32)[None, :]
        )
        state, ts = step(state, act)
        rewards.append(ts.reward)
    rewards = jnp.stack(rewards)
    fp("traj.rewards", rewards)
    print("FP traj.rewards.head:", [f"{float(r):.8e}" for r in rewards[:6, 0]])
    fp("traj.final.particles", state.scene.particles.pos)
    fp("traj.final.particles.v", state.scene.particles.vel)
    obsT = env.observe(state)
    for g in sorted(obsT):
        fp(f"traj.obs.{g}", obsT[g])
    print("DONE")


if __name__ == "__main__":
    main()
