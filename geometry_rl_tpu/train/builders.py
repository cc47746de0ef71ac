"""Agent builders — the facade assembling env + models + loss for a task.

Replaces `examples/torchrl/builders/` (AgentBuilder, make_ppo_models,
utils_algo_graph): given a task name + model name + algo settings, build the
env, graph builders, policy/critic modules, projection, and Trainer.
"""

from __future__ import annotations

from typing import Optional

from ..envs import make_env
from ..envs.cloth import ClothEnv
from ..envs.rope import RopeEnv
from ..graphs.cloth import ClothGraphBuilder
from ..graphs.flat import FlatObsBuilder
from ..graphs.rigid import RigidGraphBuilder
from ..graphs.rope import RopeGraphBuilder
from ..models import (
    DeepSets,
    DiagGaussianPolicy,
    GraphValueNet,
    MLPCritic,
    MLPGaussianPolicy,
    get_model,
)
from ..rl.projections import get_projection_layer
from .ppo import TrainConfig, Trainer

# the flat (non-graph) agent family — examples/torchrl/builders/utils_algo.py
FLAT_MODELS = ("mlp",)


def make_graph_builder(env, dist_as_pos: bool, model: str = "", **builder_kw):
    """Pick the task family's data layer (pyg_agent/data group equivalent).
    `dist_as_pos=True` marks the policy builder; the cloth critic additionally
    keeps the particle nodes (full_graph_obs, cloth hydra config value block).
    builder_kw forwards training_noise / training_noise_std etc."""
    if model.lower() in FLAT_MODELS:
        return FlatObsBuilder.from_env(env, dist_as_pos=dist_as_pos, **builder_kw)
    if isinstance(env, RopeEnv):
        return RopeGraphBuilder.from_env(env, dist_as_pos=dist_as_pos, **builder_kw)
    if isinstance(env, ClothEnv):
        return ClothGraphBuilder.from_env(
            env, dist_as_pos=dist_as_pos, full_graph_obs=not dist_as_pos, **builder_kw
        )
    return RigidGraphBuilder.from_env(env, dist_as_pos=dist_as_pos, **builder_kw)

# models whose equivariant vector output IS the action mean (post_fc=False,
# configs/*_hepi/empn_*.yaml policy.post_fc)
EQUIVARIANT_MODELS = ("hepi", "ponita_gcn", "empn")


def build_policy(model_name: str, env, latent_dim: int = 64, num_ori: int = 16, **model_kw):
    """Policy module for a task (utils_algo_graph._make_probabilistic_actor).
    Pass dtype=jnp.bfloat16 in model_kw for mixed precision (params
    stay f32; distribution outputs are cast back to f32 inside the models)."""
    cfg = env.cfg
    contextual_std = model_kw.pop("contextual_std", True)
    share_action_dim = model_kw.pop("share_action_dim", True)
    std_kw = {
        "init_std": model_kw.pop("init_std", 1.0),
        "minimal_std": model_kw.pop("minimal_std", 1e-5),
        "max_std": model_kw.pop("max_std", None),
    }
    if model_name.lower() in FLAT_MODELS:
        # flat MLP Gaussian policy over the concatenated normalized obs
        # (utils_algo.py _make_trpl_probabilistic_actor)
        model_kw.pop("dtype", None)  # flat family is tiny; keep f32
        return MLPGaussianPolicy(
            action_dim=cfg.action_dim,
            hidden_dims=(latent_dim * 4, latent_dim * 4),
            contextual_std=contextual_std,
            **std_kw,
            **model_kw,
        )
    equivariant = model_name.lower() in EQUIVARIANT_MODELS
    action_per_gripper = cfg.action_dim // cfg.num_grippers
    if equivariant:
        out_vec = action_per_gripper // 3  # 2 (6D) or 1 (3D linear)
        backbone = get_model(
            model_name,
            latent_dim=latent_dim,
            hidden_dim=latent_dim,
            output_dim=out_vec,
            output_dim_vec=out_vec,
            num_ori=num_ori,
            **model_kw,
        )
        post_fc = False
    else:
        backbone = get_model(model_name, hidden_dim=latent_dim, output_dim=latent_dim, **model_kw)
        post_fc = True
    return DiagGaussianPolicy(
        backbone=backbone,
        action_dim=cfg.action_dim,
        num_actuators=cfg.num_grippers,
        share_action_dim=share_action_dim,
        contextual_std=contextual_std,
        post_fc=post_fc,
        **std_kw,
    )


def build_critic(latent_dim: int = 64, dtype=None):
    """DeepSets critic, the configuration every reference config uses
    (configs/*:23 value model override -> deepsets + GNNVFNet final layer)."""
    import jax.numpy as jnp

    return GraphValueNet(
        backbone=DeepSets(hidden_dim=latent_dim, output_dim=latent_dim, dtype=dtype or jnp.float32)
    )


def build_agent(
    task: str = "rigid_insertion",
    model: str = "hepi",
    num_envs: int = 40,
    algo: str = "trpl",
    latent_dim: int = 64,
    num_ori: int = 16,
    mean_bound: float = 0.05,
    cov_bound: float = 0.0025,
    trust_region_coeff: float = 1.0,
    proj_type: str = "kl",
    train_cfg: Optional[TrainConfig] = None,
    env_kwargs: Optional[dict] = None,
    training_noise: bool = False,
    training_noise_std: float = 1e-2,
    entropy_schedule: Optional[str] = None,
    target_entropy: float = 0.0,
    temperature: float = 0.5,
    entropy_eq: bool = False,
    entropy_first: bool = False,
    **model_kw,
) -> Trainer:
    """AgentBuilder.build equivalent: one call -> ready Trainer."""
    env = make_env(task, num_envs=num_envs, **(env_kwargs or {}))
    policy = build_policy(model, env, latent_dim=latent_dim, num_ori=num_ori, **model_kw)
    if model.lower() in FLAT_MODELS:
        critic = MLPCritic(hidden_dims=(latent_dim * 4, latent_dim * 4))
    else:
        critic = build_critic(latent_dim=latent_dim, dtype=model_kw.get("dtype"))
    cfg = train_cfg or TrainConfig(algo=algo)
    # entropy schedules count network updates (the projection's `step` input)
    n_mb = max(1, cfg.steps_per_batch * num_envs // cfg.mini_batch_size)
    total_network_updates = cfg.total_iterations * cfg.ppo_epochs * n_mb
    projection = get_projection_layer(
        proj_type if algo == "trpl" else "ppo",
        mean_bound=mean_bound,
        cov_bound=cov_bound,
        trust_region_coeff=trust_region_coeff,
        entropy_schedule_type=entropy_schedule,
        target_entropy=target_entropy,
        temperature=temperature,
        entropy_eq=entropy_eq,
        entropy_first=entropy_first,
        action_dim=env.cfg.action_dim,
        total_train_steps=total_network_updates,
    )
    return Trainer(
        env,
        policy,
        critic,
        cfg,
        projection=projection,
        policy_builder=make_graph_builder(
            env, dist_as_pos=True, model=model,
            training_noise=training_noise, training_noise_std=training_noise_std,
        ),
        critic_builder=make_graph_builder(
            env, dist_as_pos=False, model=model,
            training_noise=training_noise, training_noise_std=training_noise_std,
        ),
    )
