"""Checkpoint evaluation — `python -m geometry_rl_tpu.train.play`.

The examples/torchrl/play.py equivalent: rebuild the agent from the run's
saved hparams, restore checkpoints (normalizer stats travel inside the
TrainState — no env-state merge workaround needed), roll out the deterministic
or stochastic policy, and write per-checkpoint mean episode returns to
eval.json (play.py:225-230).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import jax


def find_latest_run(log_root: str, prefix: str) -> str:
    """play.py `find_latest_experiment_log_dir` equivalent."""
    candidates = sorted(glob.glob(os.path.join(log_root, f"{prefix}*")))
    if not candidates:
        raise FileNotFoundError(f"no runs matching {prefix} under {log_root}")
    return candidates[-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run-dir", required=True, help="training run dir (contains hparams.json)")
    ap.add_argument("--checkpoint", default="best", help="'best', 'checkpoints', or explicit dir")
    ap.add_argument(
        "--all-checkpoints",
        action="store_true",
        help="evaluate EVERY saved checkpoint of the run (interval saves + best) "
        "and write the eval.json curve, like the reference's play.py:225-230",
    )
    ap.add_argument("--episodes-steps", type=int, default=400, help="eval rollout length")
    ap.add_argument("--eval-type", default="mode", choices=["mode", "random"])
    ap.add_argument("--num-envs", type=int, default=None, help="override eval env count")
    ap.add_argument(
        "--success-threshold",
        type=float,
        default=None,
        help="also report success rate at this object->target distance "
        "(tasks exposing the object_target_distance info key)",
    )
    ap.add_argument(
        "--record",
        default=None,
        metavar="DIR",
        help="render a rollout GIF per evaluated checkpoint into DIR "
        "(the reference play.py's video recording path)",
    )
    args = ap.parse_args(argv)

    from ..xla_config import configure_xla

    configure_xla()

    from ..config import load_config, trainer_from_config
    from .checkpoint import latest_step, restore_checkpoint

    with open(os.path.join(args.run_dir, "hparams.json")) as f:
        cfg = json.load(f)
    trained_num_envs = cfg["env"]["num_envs"]
    if args.num_envs:
        cfg["env"]["num_envs"] = args.num_envs
    cfg = load_config(None, cfg)
    trainer = trainer_from_config(cfg)

    # Evaluating with a different env count: env-sized leaves (env_state, obs)
    # cannot restore into the reshaped template, and eval_rollout resets the
    # env anyway — restore everything EXCEPT them (exclude-list, so future
    # TrainState fields are restored by default instead of silently kept
    # fresh-initialized).
    fields = None
    if args.num_envs and args.num_envs != trained_num_envs:
        from .ppo import TrainState

        fields = tuple(f for f in TrainState._fields if f not in ("env_state", "obs"))

    template = trainer.init(jax.random.PRNGKey(0))

    # (root dir, label) pairs to sweep. --all-checkpoints covers every interval
    # save plus the best checkpoint — the reference evaluates all checkpoints of
    # a run and writes the per-checkpoint eval.json curve (play.py:225-230).
    if args.all_checkpoints:
        roots = [
            (os.path.join(args.run_dir, name), name)
            for name in ("checkpoints", "best")
            if os.path.isdir(os.path.join(args.run_dir, name))
        ]
    else:
        roots = [(os.path.join(args.run_dir, args.checkpoint), args.checkpoint)]

    results = {}
    deterministic = args.eval_type == "mode"
    n_evaluated = 0
    for ckpt_root, label in roots:
        steps = sorted(
            int(d) for d in os.listdir(ckpt_root) if d.isdigit()
        ) if os.path.isdir(ckpt_root) else []
        if not steps and not args.all_checkpoints:
            raise FileNotFoundError(f"no checkpoints under {ckpt_root}")
        for step in steps:
            state = restore_checkpoint(ckpt_root, template, step, fields=fields)
            entry = {}
            ret = trainer.eval_rollout(state, n_steps=args.episodes_steps, deterministic=deterministic)
            entry["reward"] = float(ret)
            if args.success_threshold is not None:
                try:
                    succ = trainer.eval_success(
                        state, args.episodes_steps, args.success_threshold, deterministic
                    )
                    entry["success_rate"] = float(succ["success_rate"])
                    entry["mean_final_distance"] = float(succ["mean_final_distance"])
                except KeyError:
                    # task does not expose object_target_distance
                    pass
            key = str(step) if label == "checkpoints" else f"{label}/{step}"
            results[key] = entry
            n_evaluated += 1
            if args.record:
                from .render import record_rollout

                os.makedirs(args.record, exist_ok=True)
                gif = os.path.join(args.record, f"{key.replace('/', '_')}.gif")
                record_rollout(
                    trainer, state, gif, n_steps=args.episodes_steps,
                    deterministic=deterministic,
                )
                entry["video"] = gif
            extra = f" success {entry['success_rate']:.3f}" if "success_rate" in entry else ""
            print(f"checkpoint {key}: mean episode reward {entry['reward']:.3f}{extra}", flush=True)
    if not n_evaluated:
        raise FileNotFoundError(f"no checkpoints found under {args.run_dir}")

    out = os.path.join(args.run_dir, "eval.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
