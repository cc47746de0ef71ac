"""Training entry point — `python -m geometry_rl_tpu.train.cli`.

The examples/torchrl/train.py equivalent: load a task config, build the
agent, loop collect+update iterations (each one jitted XLA program), log
per-iteration scalars (same key set), checkpoint best/interval, resume.

    python -m geometry_rl_tpu.train.cli --config rigid_insertion_multi_hepi_trpl \
        --override env.num_envs=256 collector.total_frames=2000000
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import jax


def parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        # Hydra-style lowercase booleans first: ast.literal_eval would leave
        # "true"/"false" as strings, and bool("false") is True downstream.
        if val.lower() in ("true", "false"):
            node[parts[-1]] = val.lower() == "true"
            continue
        try:
            import ast

            node[parts[-1]] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            node[parts[-1]] = val
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="config name or path")
    ap.add_argument("--override", nargs="*", default=[], help="dot.key=value overrides")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    args = ap.parse_args(argv)

    from ..xla_config import configure_xla

    configure_xla()

    # Multi-process launches (GEOMRL_COORDINATOR/NUM_PROCESSES/PROCESS_ID):
    # wire the processes into one SPMD runtime BEFORE any import creates a
    # jnp constant and
    # commits the backend to single-process mode (package root is lazy for
    # exactly this reason).
    from ..parallel.multihost import is_main_process, maybe_initialize_distributed

    maybe_initialize_distributed()
    is_main = is_main_process()

    from ..config import load_config, trainer_from_config
    from .checkpoint import restore_checkpoint, save_checkpoint
    from .logging import MetricsLogger

    cfg = load_config(args.config, parse_overrides(args.override))
    trainer = trainer_from_config(cfg)

    stamp = datetime.now().strftime("%y_%m_%d-%H_%M_%S")
    if jax.process_count() > 1:
        # checkpoint saves are collective: every process must use the SAME
        # run dir, so broadcast rank 0's timestamp (seconds can differ)
        import numpy as _np
        from jax.experimental import multihost_utils

        enc = _np.frombuffer(stamp.encode().ljust(32), dtype=_np.uint8)
        enc = multihost_utils.broadcast_one_to_all(enc)
        stamp = bytes(_np.asarray(enc)).decode().strip()
    run_name = f"{cfg['task']}_{cfg['model']}_{cfg['algo']}_{stamp}"
    log_dir = os.path.join(cfg["logger"]["log_dir"], run_name)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    logger = MetricsLogger(log_dir, use_wandb=cfg["logger"].get("wandb", False)) if is_main else None
    if logger:
        logger.log_hparams(cfg)

    state = trainer.init(jax.random.PRNGKey(cfg["seed"]))
    papi_state = trainer.papi_init(state) if trainer.cfg.papi_steps else None
    start_iter = 0
    if args.resume or cfg["logger"]["checkpoint"].get("load_dir"):
        load_dir = args.resume or cfg["logger"]["checkpoint"]["load_dir"]
        from .checkpoint import latest_step

        step = latest_step(load_dir)
        state = restore_checkpoint(load_dir, state, step)
        start_iter = (step or 0) + 1
        if is_main:
            print(f"Resumed from {load_dir} @ iteration {step}")
        if papi_state is not None:
            # PAPI's cross-iteration carry (policy ring buffer, LR annealing)
            # is checkpointed beside the train state; without it a resumed
            # papi_steps run would restart at lr_scale=1 / empty history.
            papi_dir = load_dir.rstrip("/") + "_papi"
            if latest_step(papi_dir) is not None:
                papi_state = restore_checkpoint(papi_dir, papi_state)
                if is_main:
                    print(f"Resumed PAPI state from {papi_dir}")
            else:
                if is_main:
                    print(f"WARNING: no PAPI state at {papi_dir}; LR anneal/history reset")

    total_iterations = max(1, cfg["collector"]["total_frames"] // cfg["collector"]["frames_per_batch"])
    save_interval = cfg["logger"]["checkpoint"]["save_interval"]
    save_best = cfg["logger"]["checkpoint"]["save_best"]
    best_reward = -float("inf")
    frames_per_batch = trainer.cfg.steps_per_batch * trainer.env.cfg.num_envs

    # Data-parallel over every device (all cards of this host, or of every
    # process under multihost): shard the env axis, replicate params; XLA
    # inserts the gradient psums. "auto" engages whenever the env count
    # divides over >1 device; set parallel.data_parallel=false to pin one chip.
    import contextlib

    mesh_ctx = contextlib.nullcontext()
    num_envs = trainer.env.cfg.num_envs
    dp = cfg.get("parallel", {}).get("data_parallel", "auto")
    n_dev = jax.device_count()
    if dp != False and n_dev > 1 and num_envs % n_dev == 0:  # noqa: E712
        from ..parallel import make_mesh, replicate_pytree, shard_train_state

        mesh = make_mesh()
        state = shard_train_state(state, mesh, num_envs)
        if papi_state is not None:
            papi_state = replicate_pytree(papi_state, mesh)
        mesh_ctx = mesh
        if is_main:
            print(f"data-parallel: env axis {num_envs} sharded over {n_dev} devices")
    elif dp == True and n_dev > 1:  # noqa: E712
        raise ValueError(
            f"parallel.data_parallel=true but env.num_envs={num_envs} does not "
            f"divide over {n_dev} devices"
        )
    elif jax.process_count() > 1:
        # Multihost without sharding is never valid: each process would train
        # the full config independently and then collide in the collective
        # checkpoint saves under the shared run dir.
        raise ValueError(
            f"multihost launch ({jax.process_count()} processes) requires the "
            f"env axis to shard over the global mesh, but env.num_envs="
            f"{num_envs} does not divide over {n_dev} devices "
            f"(or parallel.data_parallel=false was set)"
        )

    video_cfg = None
    if cfg["env"].get("video") and is_main:
        video_cfg = {
            "interval": max(1, int(cfg["env"].get("video_interval", 50))),
            "length": int(cfg["env"].get("video_length", 0)),
            "dir": os.path.join(log_dir, cfg["env"].get("video_dir", "videos")),
        }
        os.makedirs(video_cfg["dir"], exist_ok=True)

    start = time.time()
    with mesh_ctx:
        train_loop(
            trainer, state, papi_state, logger, start_iter, total_iterations,
            save_interval, save_best, best_reward, frames_per_batch,
            ckpt_dir, log_dir, is_main, video_cfg,
        )
    if is_main:
        print(f"Training took {time.time() - start:.1f}s")
    if logger:
        logger.close()


def train_loop(
    trainer, state, papi_state, logger, start_iter, total_iterations,
    save_interval, save_best, best_reward, frames_per_batch,
    ckpt_dir, log_dir, is_main, video_cfg=None,
):
    from .checkpoint import save_checkpoint

    for i in range(start_iter, total_iterations):
        t0 = time.time()
        if papi_state is not None:
            state, papi_state, metrics = trainer.train_iteration_papi(state, papi_state)
        else:
            state, metrics = trainer.train_iteration(state)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["train/iteration_time"] = time.time() - t0
        metrics["train/frames"] = (i + 1) * frames_per_batch
        if logger:
            logger.log(i, metrics)

        reward = metrics.get("train/reward", float("nan"))
        if is_main:
            print(
                f"iter {i}/{total_iterations} reward={reward:.3f} "
                f"kl={metrics.get('kl', 0):.4f} ESS={metrics.get('ESS', 0):.3f} "
                f"({metrics['train/iteration_time']:.1f}s)",
                flush=True,
            )
        if save_interval > 0 and i % save_interval == 0:
            save_checkpoint(ckpt_dir, i, state, metrics={"reward": reward})
            if papi_state is not None:
                save_checkpoint(ckpt_dir + "_papi", i, papi_state)
        if save_best and reward == reward and reward > best_reward:  # NaN-safe
            best_reward = reward
            save_checkpoint(os.path.join(log_dir, "best"), i, state, metrics={"reward": reward})
        if video_cfg and i % video_cfg["interval"] == 0:
            # in-training recording (reference RecordVideo wiring,
            # orbit/wrappers/torchrl.py:117-123): deterministic rollout of
            # env 0 with the CURRENT policy. Never let rendering kill a run.
            try:
                from .render import record_rollout

                n_steps = video_cfg["length"] or getattr(trainer.env.cfg, "episode_length", 100)
                path = os.path.join(video_cfg["dir"], f"iter_{i:05d}.gif")
                record_rollout(trainer, state, path, n_steps=n_steps)
                print(f"recorded {path}", flush=True)
            except Exception as e:  # pragma: no cover - renderer-env dependent
                print(f"WARNING: video recording failed at iter {i}: {e}", flush=True)

    save_checkpoint(ckpt_dir, total_iterations - 1, state)
    if papi_state is not None:
        save_checkpoint(ckpt_dir + "_papi", total_iterations - 1, papi_state)


if __name__ == "__main__":
    main()
