"""YAML config system — composition-lite replacement for the Hydra stack.

The reference composes 43 Hydra YAML files (SURVEY.md §2.7). Here each task
config is one YAML that overrides a nested DEFAULTS dict (same grouping:
env / collector / algorithm.{policy,objective,projection,optim} / logger),
merged recursively — no runtime Hydra dependency, jit-friendly static values.

`load_config(path_or_name)` accepts a filesystem path or a bare name resolved
against the packaged configs/ directory (the 15 reference task configs are
mirrored there, e.g. "rigid_insertion_multi_hepi_trpl").
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

DEFAULTS: Dict[str, Any] = {
    "task": "rigid_insertion",
    "model": "hepi",
    "algo": "trpl",
    "seed": 0,
    "env": {
        "num_envs": 1000,
        "kwargs": {},
        # in-training video recording (reference env.video* keys,
        # configs/env/default.yaml:18-23 + gym.wrappers.RecordVideo wiring in
        # orbit/wrappers/torchrl.py:117-123). Here a deterministic rollout of
        # env 0 is rendered to <run>/<video_dir>/iter_xxxxx.gif every
        # `video_interval` training iterations via train/render.py.
        "video": False,
        "video_length": 0,  # 0 = one full episode
        "video_interval": 50,
        "video_dir": "videos",
    },
    "collector": {
        # frames_per_batch / num_envs = control steps per iteration
        "frames_per_batch": 100_000,
        "total_frames": 20_000_000,
    },
    "algorithm": {
        "latent_dim": 64,
        "num_ori": 16,
        "dtype": "bfloat16",  # model activation dtype (f32 params)
        "training_noise": False,  # pyg_data/utils.noise_like augmentation
        "training_noise_std": 1e-2,
        "policy": {
            "contextual_std": True,
            "share_action_dim": True,
            "init_std": 1.0,  # configs/algorithm/policy/default.yaml:9
            "minimal_std": 1e-5,
            # smooth per-dim std cap (models/policy.make_std_fn). None = exact
            # reference parametrization; set (e.g. 1.0 = the action clamp) to
            # prevent per-dim std collapse/inflation under TRPL entropy bounds.
            "max_std": None,
        },
        "objective": {
            "ppo_epochs": 5,
            "mini_batch_size": 1000,
            "gamma": 0.99,
            "gae_lambda": 0.95,
            "critic_coef": 0.5,
            "entropy_coef": 0.005,
            "entropy_bonus": True,
            "clip_value": 0.2,
            "clip_epsilon": 0.2,
            "anneal_clip_epsilon": False,
            "loss_critic_type": "l2",
            "normalize_advantage": True,
            "clip_grad_norm": False,
            "max_grad_norm": 1.0,
            # adaptive KL-penalty PPO (algo: kl_ppo — configs/algorithm/
            # objective/kl_ppo.yaml defaults; beta adapts toward dtarg)
            "dtarg": 0.01,
            "kl_beta": 1.0,
            "kl_increment": 2.0,
            "kl_decrement": 0.5,
            "kl_beta_interval": "minibatch",  # torchrl adapts per loss call;
            # "iteration" = Schulman (2017) semantics: beta fixed over the
            # update phase, adapted once from the phase-final KL
            # (docs/KL_PPO_NOTES.md — the per-minibatch controller is the
            # measured driver of the flagship plateau)
            # PAPI post-update backtracking (proj_type=papi + non-contextual std)
            "papi_steps": False,
            "papi_history": 8,
            "papi_iters": 20,
            "papi_lr_decay": 0.9,
        },
        "projection": {
            "proj_type": "kl",
            "mean_bound": 0.05,
            "cov_bound": 0.0025,
            "trust_region_coeff": 1.0,
            # entropy projection (base_projection_layer schedules; None = off)
            "entropy_schedule": None,  # null | "linear" | "exp"
            "target_entropy": 0.0,
            "temperature": 0.5,
            "entropy_eq": False,
            "entropy_first": False,
        },
        "optim": {
            "lr": 3e-4,
            "anneal_lr": False,
        },
    },
    "logger": {
        "log_dir": "logs/geometry_rl_tpu",
        "wandb": False,
        "checkpoint": {
            "save_interval": 4,
            "save_best": True,
            "max_to_keep": 5,
            "load_dir": None,
        },
    },
    "parallel": {
        # env-axis data parallelism over all visible devices (global mesh
        # under a multi-process launch). "auto" = shard whenever the
        # env count divides over >1 device; true = require it; false = pin
        # one device.
        "data_parallel": "auto",
    },
}


def _merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def warn_unknown_overrides(cfg: Dict, overrides: Dict, _path: str = "") -> None:
    """Print a warning for override keys absent from the composed config —
    silent typos (e.g. `algorithm.trainig_noise=true`) otherwise no-op.
    `env.kwargs` is open-ended (per-task env constructor kwargs) and skipped."""
    import sys

    for k, v in (overrides or {}).items():
        path = f"{_path}.{k}" if _path else k
        if k not in cfg:
            if _path.endswith("kwargs"):
                continue
            print(f"[config] WARNING: override key '{path}' is not a known config key", file=sys.stderr)
        elif isinstance(v, dict) and isinstance(cfg.get(k), dict):
            warn_unknown_overrides(cfg[k], v, path)


def load_config(path_or_name: Optional[str] = None, overrides: Optional[Dict] = None) -> Dict:
    cfg = copy.deepcopy(DEFAULTS)
    if path_or_name:
        path = path_or_name
        if not os.path.exists(path):
            path = os.path.join(CONFIG_DIR, path_or_name)
            if not path.endswith((".yaml", ".yml")):
                path += ".yaml"
        with open(path) as f:
            file_cfg = yaml.safe_load(f) or {}
        cfg = _merge(cfg, file_cfg)
    if overrides:
        warn_unknown_overrides(cfg, overrides)
        cfg = _merge(cfg, overrides)
    return cfg


def available_configs():
    if not os.path.isdir(CONFIG_DIR):
        return []
    return sorted(os.path.splitext(f)[0] for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml"))


def trainer_from_config(cfg: Dict):
    """Build a Trainer from a loaded config dict (AgentBuilder.build facade)."""
    from .train.builders import build_agent
    from .train.ppo import TrainConfig

    num_envs = cfg["env"]["num_envs"]
    steps_per_batch = max(1, cfg["collector"]["frames_per_batch"] // num_envs)
    total_iterations = max(1, cfg["collector"]["total_frames"] // cfg["collector"]["frames_per_batch"])
    obj = cfg["algorithm"]["objective"]
    opt = cfg["algorithm"]["optim"]
    beta_interval = obj.get("kl_beta_interval", "minibatch")
    if beta_interval not in ("minibatch", "iteration"):
        # Any other value would silently fall back to the per-minibatch
        # torchrl controller — the exact failure mode the knob exists to fix.
        raise ValueError(
            f"kl_beta_interval must be 'minibatch' or 'iteration', got {beta_interval!r}"
        )
    train_cfg = TrainConfig(
        algo=cfg["algo"],
        steps_per_batch=steps_per_batch,
        ppo_epochs=obj["ppo_epochs"],
        mini_batch_size=obj["mini_batch_size"],
        gamma=obj["gamma"],
        gae_lambda=obj["gae_lambda"],
        lr=opt["lr"],
        anneal_lr=opt["anneal_lr"],
        total_iterations=total_iterations,
        clip_epsilon=obj["clip_epsilon"],
        anneal_clip_epsilon=obj["anneal_clip_epsilon"],
        entropy_coef=obj["entropy_coef"],
        critic_coef=obj["critic_coef"],
        clip_value=obj["clip_value"],
        loss_critic_type=obj["loss_critic_type"],
        normalize_advantage=obj["normalize_advantage"],
        entropy_bonus=obj["entropy_bonus"],
        max_grad_norm=obj["max_grad_norm"],
        clip_grad_norm=obj["clip_grad_norm"],
        dtarg=obj.get("dtarg", 0.01),
        kl_beta=obj.get("kl_beta", 1.0),
        kl_increment=obj.get("kl_increment", 2.0),
        kl_decrement=obj.get("kl_decrement", 0.5),
        kl_beta_interval=obj.get("kl_beta_interval", "minibatch"),
        papi_steps=obj.get("papi_steps", False),
        papi_history=obj.get("papi_history", 8),
        papi_iters=obj.get("papi_iters", 20),
        papi_lr_decay=obj.get("papi_lr_decay", 0.9),
    )
    proj = cfg["algorithm"]["projection"]
    import jax.numpy as jnp

    dtype = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[cfg["algorithm"].get("dtype", "float32")]
    return build_agent(
        task=cfg["task"],
        model=cfg["model"],
        num_envs=num_envs,
        algo=cfg["algo"],
        latent_dim=cfg["algorithm"]["latent_dim"],
        num_ori=cfg["algorithm"]["num_ori"],
        dtype=dtype,
        mean_bound=proj["mean_bound"],
        cov_bound=proj["cov_bound"],
        trust_region_coeff=proj["trust_region_coeff"],
        proj_type=proj["proj_type"],
        entropy_schedule=proj.get("entropy_schedule"),
        target_entropy=proj.get("target_entropy", 0.0),
        temperature=proj.get("temperature", 0.5),
        entropy_eq=proj.get("entropy_eq", False),
        entropy_first=proj.get("entropy_first", False),
        train_cfg=train_cfg,
        contextual_std=cfg["algorithm"]["policy"].get("contextual_std", True),
        share_action_dim=cfg["algorithm"]["policy"].get("share_action_dim", True),
        init_std=cfg["algorithm"]["policy"].get("init_std", 1.0),
        minimal_std=cfg["algorithm"]["policy"].get("minimal_std", 1e-5),
        max_std=cfg["algorithm"]["policy"].get("max_std", None),
        env_kwargs=cfg["env"].get("kwargs") or {},
        training_noise=cfg["algorithm"].get("training_noise", False),
        training_noise_std=cfg["algorithm"].get("training_noise_std", 1e-2),
    )
