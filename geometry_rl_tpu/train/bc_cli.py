"""Behavior-cloning entry point — `python -m geometry_rl_tpu.train.bc_cli`.

The examples/torchrl/behavior_cloning.py equivalent: load (or record) a
rollout dataset, fit the policy mean to the recorded actions with minibatch
Adam, periodically evaluate in the env, and save the cloned policy.

    # record data with a trained checkpoint, then clone
    python -m geometry_rl_tpu.train.bc_cli --config rigid_insertion_multi_hepi_trpl \
        --checkpoint logs/.../best --record-steps 200 --epochs 50
"""

from __future__ import annotations

import argparse
import json
import os

import jax


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir for the data-collection policy")
    ap.add_argument("--data", default=None, help="existing .npz dataset (skips recording)")
    ap.add_argument("--record-steps", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--eval-steps", type=int, default=200)
    ap.add_argument(
        "--success-threshold",
        type=float,
        default=None,
        help="final deterministic success-rate eval of the cloned policy at this "
        "object->target distance (tasks exposing object_target_distance)",
    )
    ap.add_argument(
        "--fresh-actor",
        action="store_true",
        help="reinitialize the actor after --checkpoint restore (keep the "
        "normalizer stats the dataset was recorded with) — clone the expert "
        "into a FRESH policy instead of fine-tuning the expert itself",
    )
    ap.add_argument("--out-dir", default="logs/bc")
    ap.add_argument("--override", nargs="*", default=[])
    args = ap.parse_args(argv)

    from ..xla_config import configure_xla

    configure_xla()

    from ..config import load_config, trainer_from_config
    from .bc import behavior_cloning, generate_data
    from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from .cli import parse_overrides

    cfg = load_config(args.config, parse_overrides(args.override))
    trainer = trainer_from_config(cfg)
    state = trainer.init(jax.random.PRNGKey(cfg["seed"]))
    if args.checkpoint:
        state = restore_checkpoint(args.checkpoint, state, latest_step(args.checkpoint))
    if args.fresh_actor:
        fresh = trainer.init(jax.random.PRNGKey(cfg["seed"] + 1))
        state = state._replace(actor_params=fresh.actor_params)

    if args.data:
        import numpy as np

        data = dict(np.load(args.data))
    else:
        os.makedirs(args.out_dir, exist_ok=True)
        data_path = os.path.join(args.out_dir, "data.npz")
        data = generate_data(trainer, state, n_steps=args.record_steps, path=data_path)
        print(f"recorded {data['action'].shape[0]} transitions -> {data_path}")

    new_state, history = behavior_cloning(
        trainer,
        state,
        data,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        eval_every=args.eval_every,
        eval_steps=args.eval_steps,
    )
    for row in history:
        print(json.dumps(row), flush=True)

    if args.success_threshold is not None:
        # capability-grade artifact: deterministic success rate of the CLONED
        # policy (reference workflow: behavior_cloning.py periodic eval_model)
        succ = trainer.eval_success(new_state, args.eval_steps, args.success_threshold)
        summary = {
            "success_rate": float(succ["success_rate"]),
            "mean_final_distance": float(succ["mean_final_distance"]),
            "threshold": args.success_threshold,
            "transitions": int(data["action"].shape[0]),
            "epochs": args.epochs,
        }
        history.append({"final_eval": summary})
        print(json.dumps({"final_eval": summary}), flush=True)

    save_checkpoint(os.path.join(args.out_dir, "cloned"), args.epochs, new_state)
    with open(os.path.join(args.out_dir, "bc_history.json"), "w") as f:
        json.dump(history, f, indent=2)
    print(f"saved cloned policy to {args.out_dir}/cloned")


if __name__ == "__main__":
    main()
