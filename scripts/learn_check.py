import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
"""Learning sanity check: train rigid_insertion HEPi+TRPL briefly on the accelerator and
report the episode-reward trend. Not a unit test (takes minutes); run manually
or via the driver."""

import argparse
import json
import time

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="rigid_insertion")
    ap.add_argument("--model", default="hepi")
    ap.add_argument("--algo", default="trpl")
    ap.add_argument("--num-envs", type=int, default=512)
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--steps-per-batch", type=int, default=100)
    ap.add_argument("--mini-batch", type=int, default=1000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-dir", default=None, help="checkpoint the final state here")
    ap.add_argument("--success-threshold", type=float, default=0.1)
    ap.add_argument("--env-kw", nargs="*", default=[], help="extra env kwargs key=value (floats)")
    args = ap.parse_args()

    from geometry_rl_tpu.train import TrainConfig
    from geometry_rl_tpu.train.builders import build_agent

    import jax.numpy as jnp

    trainer = build_agent(
        task=args.task,
        model=args.model,
        num_envs=args.num_envs,
        algo=args.algo,
        latent_dim=64,
        num_ori=16,
        dtype=jnp.bfloat16,
        train_cfg=TrainConfig(
            algo=args.algo,
            steps_per_batch=args.steps_per_batch,
            ppo_epochs=5,
            mini_batch_size=args.mini_batch,
            total_iterations=args.iterations,
        ),
        env_kwargs={"warmup_steps": 0, **{k: float(v) for k, v in (s.split("=", 1) for s in args.env_kw)}},
    )
    state = trainer.init(jax.random.PRNGKey(0))

    history = []
    t0 = time.time()
    for i in range(args.iterations):
        it_t = time.time()
        state, metrics = trainer.train_iteration(state)
        reward = float(metrics["train/reward"])
        history.append(reward)
        print(
            json.dumps(
                {
                    "iter": i,
                    "reward": round(reward, 4),
                    # pure-PPO emits no trust-region KL metric
                    **{
                        k: round(float(metrics[k]), 6)
                        for k in ("kl", "ESS", "entropy", "loss_critic", "beta")
                        if k in metrics
                    },
                    "explained_var": round(float(metrics["train/explained_variance"]), 4),
                    "it_time": round(time.time() - it_t, 2),
                }
            ),
            flush=True,
        )

    first = sum(history[:5]) / 5
    last = sum(history[-5:]) / 5
    summary = {
        "task": args.task,
        "model": args.model,
        "first5_mean_reward": round(first, 3),
        "last5_mean_reward": round(last, 3),
        "improved": last > first,
        "total_time_s": round(time.time() - t0, 1),
        "env_steps": args.iterations * args.steps_per_batch * args.num_envs,
    }
    if hasattr(trainer, "eval_success") and args.task.startswith("rigid"):
        try:
            ev = trainer.eval_success(state, n_steps=trainer.env.cfg.episode_length * 2, threshold=args.success_threshold)
            summary["eval_success_rate"] = round(float(ev["success_rate"]), 4)
            summary["eval_mean_final_distance"] = round(float(ev["mean_final_distance"]), 4)
        except Exception as e:
            summary["eval_error"] = str(e)
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.save_dir:
        from geometry_rl_tpu.train.checkpoint import save_checkpoint

        save_checkpoint(args.save_dir, args.iterations, state)
        print(f"checkpointed -> {args.save_dir}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": history, **summary}, f)


if __name__ == "__main__":
    main()
