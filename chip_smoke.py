#!/usr/bin/env python3
"""Smoke test of the system on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # four cards: data-parallel phase only

Phases (one card), in order; any failure exits non-zero:

1. Device: JAX's default device must be a GPU (no CPU fallback). Prints the
   card's name and power limit, the JAX version and the main path's imports.
2. Main path: `train.cli` on rigid_insertion_multi_hepi_trpl at its own
   sizes (1000 envs x 100 steps, HEPi latent 64 / 16 orientations in bf16,
   TRPL 5 epochs of 1000-sample minibatches) for 3 iterations
   (collector.total_frames=300000), then `train.play` on the run; metrics
   finite, a checkpoint restored, eval.json written.
3. Physics parity: the golden trajectories of tests/golden/ at the tests'
   tolerances; rigid_insertion at 1000 envs for 20 steps against the same
   program on the CPU in f32.
4. Model parity: the HEPi policy forward at flagship width and 1000 envs in
   bf16 against an f32 forward at precision "highest" on the same
   parameters; the on-device KL projection against the native solver.
5. Cloth kernel: the fused position solve against the XLA solver at 256 envs.

`--four-cards`: in one process over a mesh of 4 cards, 3 iterations of the
phase-2 configuration (250 envs per card), and one train_iteration on 4 cards
against the same seed on 1 card (printed); the gradient of one 1000-sample
minibatch sharded over 4 cards against 1 card in f32 at "highest" (gated).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Run outputs go to <repo>/logs/chip_smoke/.
"""

import argparse
import glob
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = "rigid_insertion_multi_hepi_trpl"
LOG_ROOT = os.path.join(ROOT, "logs", "chip_smoke")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------- phase 1


def phase_device():
    import jax

    from bench import card_name_and_power_limit

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX's default device is {dev.platform!r}, not a GPU")
    card = card_name_and_power_limit()
    print(f"card: {card}")
    print(f"jax {jax.__version__}; {len(jax.devices())} x {dev.device_kind}")
    for name in ("numpy", "scipy", "optax", "yaml"):
        mod = importlib.import_module(name)
        print(f"import {name} {getattr(mod, '__version__', '?')}")
    return dev, card


# ----------------------------------------------------------------- phase 2


def run_cli(log_dir, card, overrides=()):
    """Train the flagship for 3 iterations through `train.cli`; returns the
    run dir after checking its metrics."""
    from geometry_rl_tpu.train import cli

    shutil.rmtree(log_dir, ignore_errors=True)
    cli.main(["--config", FLAGSHIP, "--override", "collector.total_frames=300000",
              f"logger.log_dir={log_dir}", *overrides])
    (run_dir,) = glob.glob(os.path.join(log_dir, "*"))
    with open(os.path.join(run_dir, "hparams.json")) as f:
        hp = json.load(f)
    alg = hp["algorithm"]
    check(hp["env"]["num_envs"] == 1000 and hp["collector"]["frames_per_batch"] == 100_000,
          "flagship env sizes changed")
    check(alg["latent_dim"] == 64 and alg["num_ori"] == 16 and alg["dtype"] == "bfloat16",
          "flagship model sizes changed")
    check(alg["objective"]["ppo_epochs"] == 5 and alg["objective"]["mini_batch_size"] == 1000,
          "flagship update sizes changed")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == 3, f"expected 3 logged iterations, got {len(rows)}")
    for row in rows:
        bad = [k for k, v in row.items() if isinstance(v, float) and not math.isfinite(v)]
        check(not bad, f"non-finite metrics at iteration {row.get('step')}: {bad}")
        print(f"[{card}] iteration {row.get('step')}: {row['train/iteration_time']:.2f} s, "
              f"loss_objective {row.get('loss_objective', float('nan')):.4f}")
    return run_dir


def phase_main_path(dev, card):
    import jax
    import numpy as np

    from geometry_rl_tpu.config import load_config, trainer_from_config
    from geometry_rl_tpu.train import play
    from geometry_rl_tpu.train.checkpoint import latest_step, restore_checkpoint

    run_dir = run_cli(os.path.join(LOG_ROOT, "main_path"), card)
    ckpt = os.path.join(run_dir, "checkpoints")
    check(latest_step(ckpt) == 2, f"final checkpoint missing under {ckpt}")
    with open(os.path.join(run_dir, "hparams.json")) as f:
        trainer = trainer_from_config(load_config(None, json.load(f)))
    template = trainer.init(jax.random.PRNGKey(0))
    restored = restore_checkpoint(ckpt, template)
    check(int(restored.num_updates) > 0, "restored checkpoint has no updates")
    for leaf in jax.tree_util.tree_leaves(restored.actor_params):
        check(bool(np.isfinite(np.asarray(leaf)).all()), "restored actor params not finite")
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(restored.actor_params), jax.tree_util.tree_leaves(template.actor_params)))
    check(moved > 0, "restored actor params equal the fresh init")

    play.main(["--run-dir", run_dir, "--checkpoint", "checkpoints"])
    with open(os.path.join(run_dir, "eval.json")) as f:
        ev = json.load(f)
    check(ev and all(math.isfinite(e["reward"]) for e in ev.values()), f"bad eval.json {ev}")
    stats = dev.memory_stats() or {}
    print(f"[{card}] main path ok: restored step {latest_step(ckpt)}, eval {ev}, "
          f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not reported')}")


# ----------------------------------------------------------------- phase 3


# Both sides are f32 at "highest": only the order of operations differs
# (7e-7 m measured). TF32 contractions (10 mantissa bits) would move
# positions by ~1e-3 m.
GPU_CPU_ATOL = 1e-4


def phase_physics(card):
    import jax
    import numpy as np

    golden = load_module(os.path.join(ROOT, "tests", "test_golden_trajectories.py"), "golden_gate")
    for task in sorted(golden.CASES):
        check(os.path.exists(os.path.join(golden.GOLDEN_DIR, f"{task}.npz")), f"golden {task} missing")
        golden.test_golden_trajectory(task)  # asserts atol=5e-3, rtol=1e-3
        print(f"golden {task}: ok")
    sim_tests = load_module(os.path.join(ROOT, "tests", "test_sim.py"), "sim_tests")
    sim_tests.test_two_joints_on_one_body_stay_stable()
    print("golden two_agent_joint_stress: ok")

    from geometry_rl_tpu.envs import make_env

    def rollout(device, steps=20, B=1000):
        with jax.default_device(device):
            env = make_env("rigid_insertion", num_envs=B)
            step = jax.jit(env.step)
            state = env.reset(jax.random.PRNGKey(0))
            A = env.cfg.action_dim
            for t in range(steps):
                state, _ = step(state, golden_actions(B, A, t))
            return np.asarray(state.scene.bodies.pos)

    gpu_pos = rollout(jax.devices()[0])
    cpu_pos = rollout(jax.devices("cpu")[0])
    check(np.isfinite(gpu_pos).all(), "GPU rigid_insertion positions not finite")
    diff = float(np.abs(gpu_pos - cpu_pos).max())
    print(f"[{card}] rigid_insertion 1000 envs x 20 steps, GPU vs CPU f32: "
          f"max |position difference| {diff:.3e} m (gate {GPU_CPU_ATOL} m)")
    check(diff <= GPU_CPU_ATOL, "rigid_insertion GPU vs CPU positions differ")


def golden_actions(B, A, t):
    """The golden-trajectory tests' deterministic quasi-random actions."""
    import jax.numpy as jnp

    return jnp.sin(jnp.arange(B * A, dtype=jnp.float32).reshape(B, A) * 0.7 + t * 0.3)


# ----------------------------------------------------------------- phase 4

# bf16 keeps 8 significant bits (relative rounding 2^-9 per operation); over
# the HEPi stack of ~10 contractions and norms the error compounds to a few
# per cent of the output's scale. The gate is 5% of the largest |f32 output|.
BF16_REL_TOL = 0.05


def phase_model(card):
    import jax
    import numpy as np

    from geometry_rl_tpu import native
    from geometry_rl_tpu.config import load_config, trainer_from_config
    from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply
    from geometry_rl_tpu.rl.projections.kl import kl_diag_cov_projection

    cfg = load_config(FLAGSHIP, {"env": {"kwargs": {"warmup_steps": 0}}})
    bf16 = trainer_from_config(cfg)
    f32 = trainer_from_config(load_config(FLAGSHIP, {"env": {"kwargs": {"warmup_steps": 0}},
                                                     "algorithm": {"dtype": "float32"}}))
    state = bf16.init(jax.random.PRNGKey(1))
    tobs = obs_norm_apply(state.norm, state.obs)
    d16 = jax.jit(bf16._policy_dist)(state.actor_params, tobs)
    with jax.default_matmul_precision("highest"):
        d32 = jax.jit(f32._policy_dist)(state.actor_params, tobs)
    for name in ("mean", "std"):
        a, b = np.asarray(getattr(d16, name)), np.asarray(getattr(d32, name))
        check(a.shape == b.shape == (1000, bf16.env.cfg.action_dim), f"{name} shape {a.shape}")
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"[{card}] HEPi forward bf16 vs f32-highest, 1000 envs: {name} max |diff| "
              f"{err:.3e}, max |f32| {scale:.3e} (gate {BF16_REL_TOL} x max |f32|)")
        check(np.isfinite(a).all() and err <= BF16_REL_TOL * scale, f"HEPi {name} parity failed")

    rng = np.random.default_rng(0)
    shape = (1000, bf16.env.cfg.action_dim)
    var = np.exp(rng.normal(size=shape)).astype(np.float32)
    old_var = np.exp(rng.normal(size=shape)).astype(np.float32)
    dev_out = np.asarray(jax.jit(kl_diag_cov_projection, static_argnums=2)(var, old_var, 0.0025))
    ref = native.diag_kl_project(var, old_var, 0.0025)
    err = float(np.max(np.abs(dev_out - ref) / (np.abs(ref) + 1e-6)))
    print(f"[{card}] KL projection {shape} vs native solver (native build: {native.HAVE_NATIVE}): "
          f"max rel diff {err:.3e} (gate 2e-3, as tests/test_native.py)")
    np.testing.assert_allclose(dev_out, ref, rtol=2e-3, atol=1e-6)


# ----------------------------------------------------------------- phase 5

CLOTH_ATOL = 2e-4  # f32 both sides; only the order of operations differs


def cloth_kernel_parity(num_envs: int = 256, steps: int = 10, seed: int = 7) -> dict:
    """Largest kernel-vs-XLA position difference over `steps` env steps (each
    of `decimation` substeps), each solver advancing the same state so that
    rounding noise is not compounded through the contact dynamics."""
    import jax
    import jax.numpy as jnp

    from geometry_rl_tpu.envs import make_env

    env = make_env("cloth_hanging", num_envs=num_envs, warmup_steps=0, use_pallas_solver=False)
    state = env.reset(jax.random.PRNGKey(seed))
    xla = jax.jit(env._physics)
    kernel = jax.jit(env._physics_pallas)
    worst = {"particles": 0.0, "bodies": 0.0}
    for t in range(steps):
        pre = env._apply_action(state.scene, golden_actions(num_envs, env.cfg.action_dim, t))
        sx = xla(pre, state.hanger_pos)
        sk = kernel(pre, state.hanger_pos)
        worst["particles"] = max(worst["particles"], float(jnp.abs(sk.particles.pos - sx.particles.pos).max()))
        worst["bodies"] = max(worst["bodies"], float(jnp.abs(sk.bodies.pos - sx.bodies.pos).max()))
        state = state._replace(scene=sx)
    return worst


def phase_cloth_kernel(card):
    worst = cloth_kernel_parity()
    print(f"[{card}] cloth kernel vs XLA solver, 256 envs x 20 substeps: max |diff| {worst} "
          f"(gate {CLOTH_ATOL})")
    check(max(worst.values()) <= CLOTH_ATOL, "cloth kernel parity failed")


# ------------------------------------------------------------ four cards


def phase_four_cards(card):
    import jax

    check(len(jax.devices()) == 4, f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    run_cli(os.path.join(LOG_ROOT, "four_cards"), card)

    # bf16 (the flagship as trained), printed only: the 500 Adam steps of
    # an iteration amplify any rounding difference, and the update metrics
    # of 1 and 4 cards drift apart by a few per cent (in f32 at "highest"
    # too: PERF.md).
    one_vs_four(card)
    # What exists only across cards, gated: the gradient of one 1000-sample
    # minibatch with the samples sharded over 4 cards, against 1 card, in
    # f32 at "highest". Only the order of the f32 sums differs.
    err = minibatch_gradient_diff({"algorithm": {"dtype": "float32"}}, 4)
    print(f"[{card}] minibatch gradient, f32 highest, 4 cards vs 1: max |diff| / max |grad| "
          f"{err:.3e} (gate {GRAD_RTOL})")
    check(err <= GRAD_RTOL, "cross-card gradient differs from the one-card gradient")


# f32 sums over 1000 samples in another order differ by ~1e-6 of their
# scale; a card left out of the reduction would differ by ~25%.
GRAD_RTOL = 1e-4


def minibatch_gradient_diff(overrides, n_devices):
    """Largest difference between the actor and critic gradients of one
    minibatch (all envs' first observations, the policy's own actions and
    random advantages) on a mesh of `n_devices` and on one device, relative
    to the largest gradient entry; f32 at "highest"."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from geometry_rl_tpu.config import load_config, trainer_from_config
    from geometry_rl_tpu.parallel import make_mesh, replicate_pytree, shard_env_pytree
    from geometry_rl_tpu.rl import gaussian as G
    from geometry_rl_tpu.rl.obs_pipeline import obs_norm_apply

    trainer = trainer_from_config(load_config(FLAGSHIP, overrides))
    state = trainer.init(jax.random.PRNGKey(0))
    B = trainer.env.cfg.num_envs
    k_act, k_adv, k_val = jax.random.split(jax.random.PRNGKey(1), 3)
    tobs = obs_norm_apply(state.norm, state.obs)
    dist = trainer._policy_dist(state.actor_params, tobs)
    action = G.sample(k_act, dist)
    mb = {"tobs": tobs, "action": action, "log_prob": G.log_prob(dist, action),
          "mean": dist.mean, "std": dist.std, "value": trainer._value(state.critic_params, tobs),
          "advantage": jax.random.normal(k_adv, (B,)), "value_target": jax.random.normal(k_val, (B,)),
          "env_ids": jnp.arange(B, dtype=jnp.int32)}
    params = (state.actor_params, state.critic_params)

    @jax.jit
    def grad(params, mb):
        return jax.grad(trainer._minibatch_loss, argnums=(0, 1), has_aux=True)(
            *params, mb, state.num_updates, state.initial_entropy, state.kl_beta)[0]

    out = []
    with jax.default_matmul_precision("highest"):
        for n in (1, n_devices):
            mesh = make_mesh(n)
            with mesh:
                g = grad(replicate_pytree(params, mesh), shard_env_pytree(mb, mesh, B))
            out.append([np.asarray(x) for x in jax.tree_util.tree_leaves(g)])
    scale = max(float(np.abs(x).max()) for x in out[0])
    return max(float(np.abs(a - b).max()) for a, b in zip(*out)) / scale


def one_vs_four(card):
    """One flagship train_iteration on 1 card and on 4 from the same state;
    prints every metric and the worst actor-parameter difference."""
    import jax
    import numpy as np

    from geometry_rl_tpu.config import load_config, trainer_from_config
    from geometry_rl_tpu.parallel import make_mesh, shard_train_state

    trainer = trainer_from_config(load_config(FLAGSHIP, {}))
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_iteration)
    out = {}
    for n in (1, 4):
        mesh = make_mesh(n)
        with mesh:
            t0 = time.perf_counter()
            new_state, metrics = step(shard_train_state(state, mesh, 1000))
            jax.block_until_ready(metrics)
        print(f"[{card}] train_iteration on {n} card(s) (first call, compile included): "
              f"{time.perf_counter() - t0:.2f} s")
        out[n] = (new_state, {k: float(v) for k, v in metrics.items()})
    for k, a in sorted(out[1][1].items()):
        b = out[4][1][k]
        check(math.isfinite(a) and math.isfinite(b), f"metric {k} not finite: 1 card {a}, 4 cards {b}")
        print(f"[{card}] {k}: 1 card {a:.6g}, 4 cards {b:.6g}, rel diff {abs(a - b) / max(abs(a), 1e-6):.3e}")
    worst = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(out[1][0].actor_params), jax.tree_util.tree_leaves(out[4][0].actor_params)))
    print(f"[{card}] 1 vs 4 cards: worst actor-param |diff| after the update {worst:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true", help="run only the four-card data-parallel phase")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "geometry_rl_tpu")):
        print("chip_smoke: FAILED: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from geometry_rl_tpu.xla_config import configure_xla

        cache_dir = configure_xla()
        cached_before = len(glob.glob(os.path.join(cache_dir, "*")))
        dev, card = phase_device()
        phases = [phase_four_cards] if args.four_cards else [
            phase_main_path, phase_physics, phase_model, phase_cloth_kernel]
        for phase in phases:
            t0 = time.perf_counter()
            print(f"== {phase.__name__}", flush=True)
            phase(dev, card) if phase is phase_main_path else phase(card)
            print(f"== {phase.__name__} ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        cached_after = len(glob.glob(os.path.join(cache_dir, "*")))
        print(f"compile cache {cache_dir}: {cached_before} entries before, {cached_after} after")
    except Exception as e:  # report, then fail: nothing is passed over
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    import jax

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
