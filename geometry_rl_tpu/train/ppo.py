"""On-device TRPL / PPO trainer — collect, GAE, and update in one jit.

JAX redesign of `examples/torchrl/train.py` + the SyncDataCollector: the
reference stepped the sim and policy in Python, stored batches on CPU
(`storing_device="cpu"`, train.py:120), and round-tripped dist params through
a C++ projection per minibatch. Here one `train_iteration` is a single XLA
program: `lax.scan` rollout over T control steps -> GAE -> ppo_epochs x
minibatch scans, with the KL projection fused into the loss. Nothing leaves
the device; host code only reads scalar metrics.

Layout notes: batch axes [T, B] -> flattened [T*B] for the update;
graph rebuilds per minibatch gather per-env static topology by env id (the
reference also rebuilds the PyG graph per minibatch — trpl call stack §3.1).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..graphs.rigid import RigidGraphBuilder
from ..rl import gaussian as G
from ..rl.gae import gae
from ..rl.losses import LossInputs, kl_pen_ppo_loss, ppo_clip_loss, trpl_loss
from ..rl.obs_pipeline import ObsNormState, obs_norm_apply, obs_norm_init, obs_norm_step
from ..rl.projections import BaseProjection


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors configs/algorithm/{trpl,ppo}.yaml + objective/optim groups."""

    algo: str = "trpl"  # trpl | ppo | kl_ppo
    steps_per_batch: int = 100  # control steps per env per iteration
    ppo_epochs: int = 5
    mini_batch_size: int = 1000
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    anneal_lr: bool = False
    total_iterations: int = 200  # for annealing schedules
    clip_epsilon: float = 0.2
    anneal_clip_epsilon: bool = False
    entropy_coef: float = 0.005
    critic_coef: float = 0.5
    clip_value: float = 0.2
    loss_critic_type: str = "l2"
    normalize_advantage: bool = True
    entropy_bonus: bool = True
    max_grad_norm: float = 1.0
    clip_grad_norm: bool = False
    # adaptive KL-penalty PPO (algo="kl_ppo"; configs/algorithm/objective/
    # kl_ppo.yaml defaults)
    dtarg: float = 0.01
    kl_beta: float = 1.0
    kl_increment: float = 2.0
    kl_decrement: float = 0.5
    # "minibatch": torchrl KLPENPPOLoss semantics (beta adapts on every loss
    # call — hundreds of multiplicative updates per iteration). "iteration":
    # Schulman (2017) semantics — beta held fixed over the whole update phase,
    # adapted ONCE from the phase-final KL. The per-minibatch controller is a
    # measured relaxation oscillator at flagship scale (beta ramps 0.01->1e5
    # within an iteration, the penalty-gradient spike poisons Adam's second
    # moment, the policy freezes for ~40 iterations while v decays — see
    # docs/KL_PPO_NOTES.md).
    kl_beta_interval: str = "minibatch"
    # PAPI post-update steps (papi_projection.py:151-245); requires
    # proj_type="papi" and a non-contextual-std policy with a Dense mean head
    papi_steps: bool = False
    papi_history: int = 8
    papi_iters: int = 20
    papi_lr_decay: float = 0.9  # multiplicative LR anneal per backtracking event
    # (the reference steps a torch lr_schedule instead — documented deviation)


class TrainState(NamedTuple):
    actor_params: Any
    critic_params: Any
    actor_opt: Any
    critic_opt: Any
    norm: ObsNormState
    env_state: Any
    obs: Dict[str, jnp.ndarray]  # raw obs of the current env state
    key: jax.Array
    num_updates: jnp.ndarray  # network update counter (annealing + proj step)
    initial_entropy: jnp.ndarray  # mean policy entropy at init (entropy schedule e0,
    # base_projection_layer initial_entropy — frozen after trainer.init)
    kl_beta: Any = None  # adaptive KL-penalty coefficient (algo="kl_ppo" only;
    # None — a leafless pytree node — for trpl/ppo, keeping their checkpoint
    # structure unchanged)


class Batch(NamedTuple):
    tobs: Dict[str, jnp.ndarray]  # transformed obs groups [T, B, D]
    action: jnp.ndarray  # [T, B, A]
    log_prob: jnp.ndarray  # [T, B]
    mean: jnp.ndarray  # [T, B, A] behavior dist
    std: jnp.ndarray  # [T, B, A]
    value: jnp.ndarray  # [T, B]
    reward: jnp.ndarray
    done: jnp.ndarray


class Trainer:
    """Wires env + graph builders + models + loss into jitted train steps."""

    def __init__(
        self,
        env,
        policy,  # models.nn module: (graph, feats) -> DiagGaussian
        critic,  # models.nn module: (graph, feats) -> [B]
        cfg: TrainConfig,
        projection: Optional[BaseProjection] = None,
        policy_builder: Optional[RigidGraphBuilder] = None,
        critic_builder: Optional[RigidGraphBuilder] = None,
    ):
        self.env = env
        self.policy = policy
        self.critic = critic
        self.cfg = cfg
        self.projection = projection
        self.policy_builder = policy_builder or RigidGraphBuilder.from_env(env, dist_as_pos=True)
        self.critic_builder = critic_builder or RigidGraphBuilder.from_env(env, dist_as_pos=False)

        B = env.cfg.num_envs
        n_samples = cfg.steps_per_batch * B
        self.num_minibatches = max(1, n_samples // cfg.mini_batch_size)
        self.mini_batch_size = min(cfg.mini_batch_size, n_samples)
        self.total_network_updates = cfg.total_iterations * cfg.ppo_epochs * self.num_minibatches

        sched: Callable[[jnp.ndarray], jnp.ndarray]
        if cfg.anneal_lr:
            sched = optax.linear_schedule(cfg.lr, 0.0, self.total_network_updates)
        else:
            sched = cfg.lr
        def make_opt():
            tx = optax.adam(sched, eps=1e-5)
            if cfg.clip_grad_norm:
                tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), tx)
            return tx

        self.actor_tx = make_opt()
        self.critic_tx = make_opt()

    # ------------------------------------------------------------------ init

    def init(self, key: jax.Array) -> TrainState:
        env = self.env
        k_env, k_actor, k_critic, k_rest = jax.random.split(key, 4)
        env_state = env.reset(k_env)
        obs = env.observe(env_state)

        norm = obs_norm_init(env.obs_spec.group_dim("scalars"))
        tobs = obs_norm_apply(norm, obs)

        from ..models.calibration import calibrate

        g_p, f_p = self.policy_builder.build(tobs)
        actor_params = self.policy.init(k_actor, g_p, f_p)
        actor_params = calibrate(self.policy, actor_params, g_p, f_p)
        dist0 = self.policy.apply(actor_params, g_p, f_p)
        initial_entropy = G.entropy(dist0).mean()
        g_c, f_c = self.critic_builder.build(tobs)
        critic_params = self.critic.init(k_critic, g_c, f_c)
        critic_params = calibrate(self.critic, critic_params, g_c, f_c)
        # calibrate() strips sown collections; both param trees now hold
        # exactly the trainable "params" collection

        return TrainState(
            actor_params=actor_params,
            critic_params=critic_params,
            actor_opt=self.actor_tx.init(actor_params),
            critic_opt=self.critic_tx.init(critic_params),
            norm=norm,
            env_state=env_state,
            obs=obs,
            key=k_rest,
            num_updates=jnp.zeros((), jnp.int32),
            initial_entropy=initial_entropy,
            kl_beta=jnp.asarray(self.cfg.kl_beta, jnp.float32) if self.cfg.algo == "kl_ppo" else None,
        )

    # --------------------------------------------------------------- forward

    def _policy_dist(self, params, tobs, env_ids=None, noise_key=None, inference=False) -> G.DiagGaussian:
        if noise_key is not None and getattr(self.policy_builder, "training_noise", False):
            graph, feats = self.policy_builder.build(tobs, env_ids, noise_key=noise_key)
        else:
            graph, feats = self.policy_builder.build(tobs, env_ids)
        del inference  # collection and update share the XLA forward
        return self.policy.apply(params, graph, feats)

    def _value(self, params, tobs, env_ids=None, noise_key=None) -> jnp.ndarray:
        if noise_key is not None and getattr(self.critic_builder, "training_noise", False):
            graph, feats = self.critic_builder.build(tobs, env_ids, noise_key=noise_key)
        else:
            graph, feats = self.critic_builder.build(tobs, env_ids)
        return self.critic.apply(params, graph, feats)

    # --------------------------------------------------------------- collect

    def _collect(self, state: TrainState) -> Tuple[TrainState, Batch, Dict[str, jnp.ndarray]]:
        env = self.env
        B = env.cfg.num_envs

        def step_fn(carry, _):
            env_state, obs, norm, key, cum_rew, ep_sum, ep_cnt = carry
            key, k_act = jax.random.split(key)

            norm, tobs = obs_norm_step(norm, obs, update=True)
            dist = self._policy_dist(state.actor_params, tobs, inference=True)
            action = G.sample(k_act, dist)
            log_prob = G.log_prob(dist, action)
            value = self._value(state.critic_params, tobs)

            env_state, ts = env.step(env_state, action)

            cum_rew = cum_rew + ts.reward
            ep_sum = ep_sum + jnp.where(ts.done, cum_rew, 0.0).sum()
            ep_cnt = ep_cnt + ts.done.sum()
            cum_rew = jnp.where(ts.done, 0.0, cum_rew)

            out = Batch(
                tobs=tobs,
                action=action,
                log_prob=log_prob,
                mean=dist.mean,
                std=dist.std,
                value=value,
                reward=ts.reward,
                done=ts.done,
            )
            return (env_state, ts.obs, norm, key, cum_rew, ep_sum, ep_cnt), out

        carry0 = (
            state.env_state,
            state.obs,
            state.norm,
            state.key,
            jnp.zeros((B,)),
            jnp.zeros(()),
            jnp.zeros((), jnp.int32),
        )
        (env_state, obs, norm, key, _, ep_sum, ep_cnt), batch = jax.lax.scan(
            step_fn, carry0, None, length=self.cfg.steps_per_batch
        )
        new_state = state._replace(env_state=env_state, obs=obs, norm=norm, key=key)
        stats = {
            "train/reward": jnp.where(ep_cnt > 0, ep_sum / jnp.maximum(ep_cnt, 1), jnp.nan),
            "train/episodes": ep_cnt.astype(jnp.float32),
        }
        return new_state, batch, stats

    # ---------------------------------------------------------------- update

    def _minibatch_loss(self, actor_params, critic_params, mb, num_updates, initial_entropy=None, kl_beta=None):
        cfg = self.cfg
        # training-noise augmentation (base_data training_noise): fresh draw
        # per network update, applied only on training forwards
        nk_a = nk_c = None
        if getattr(self.policy_builder, "training_noise", False) or getattr(
            self.critic_builder, "training_noise", False
        ):
            nk = jax.random.fold_in(jax.random.PRNGKey(0x6E015E), num_updates)
            nk_a, nk_c = jax.random.split(nk)
        dist = self._policy_dist(actor_params, mb["tobs"], mb["env_ids"], noise_key=nk_a)
        value = self._value(critic_params, mb["tobs"], mb["env_ids"], noise_key=nk_c)
        inputs = LossInputs(
            action=mb["action"],
            sample_log_prob=mb["log_prob"],
            advantage=mb["advantage"],
            value_target=mb["value_target"],
            old_value=mb["value"],
        )
        if cfg.algo == "trpl":
            old_dist = G.DiagGaussian(mb["mean"], mb["std"])
            actor_loss, critic_loss, metrics = trpl_loss(
                dist,
                old_dist,
                value,
                inputs,
                self.projection,
                step=num_updates,
                initial_entropy=initial_entropy,
                entropy_coef=cfg.entropy_coef,
                critic_coef=cfg.critic_coef,
                clip_value=cfg.clip_value,
                loss_critic_type=cfg.loss_critic_type,
                normalize_advantage=cfg.normalize_advantage,
                entropy_bonus=cfg.entropy_bonus,
            )
        elif cfg.algo == "kl_ppo":
            old_dist = G.DiagGaussian(mb["mean"], mb["std"])
            actor_loss, critic_loss, new_beta, metrics = kl_pen_ppo_loss(
                dist,
                old_dist,
                value,
                inputs,
                kl_beta,
                dtarg=cfg.dtarg,
                increment=cfg.kl_increment,
                decrement=cfg.kl_decrement,
                entropy_coef=cfg.entropy_coef,
                critic_coef=cfg.critic_coef,
                loss_critic_type=cfg.loss_critic_type,
                normalize_advantage=cfg.normalize_advantage,
                entropy_bonus=cfg.entropy_bonus,
                # "iteration" = Schulman semantics: beta is a constant of the
                # update phase; the adapt step runs once per iteration in
                # _update instead, so the loss must not adapt per minibatch.
                adapt=cfg.kl_beta_interval != "iteration",
            )
            return actor_loss + critic_loss, (metrics, new_beta)
        else:
            clip_eps = cfg.clip_epsilon
            if cfg.anneal_clip_epsilon:
                frac = 1.0 - num_updates / self.total_network_updates
                clip_eps = cfg.clip_epsilon * frac
            actor_loss, critic_loss, metrics = ppo_clip_loss(
                dist,
                value,
                inputs,
                clip_epsilon=clip_eps,
                entropy_coef=cfg.entropy_coef,
                critic_coef=cfg.critic_coef,
                clip_value=cfg.clip_value,
                loss_critic_type=cfg.loss_critic_type,
                normalize_advantage=cfg.normalize_advantage,
                entropy_bonus=cfg.entropy_bonus,
            )
        return actor_loss + critic_loss, (metrics, kl_beta)

    def _update(
        self, state: TrainState, batch: Batch, lr_scale: Optional[jnp.ndarray] = None
    ) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
        cfg = self.cfg
        env = self.env
        B = env.cfg.num_envs
        T = cfg.steps_per_batch

        # GAE (train.py adv_module; bootstrap with the current critic on the
        # post-rollout observation)
        _, final_tobs = obs_norm_step(state.norm, state.obs, update=False)
        bootstrap = self._value(state.critic_params, final_tobs)
        advantage, value_target = gae(
            batch.reward, batch.value, batch.done.astype(jnp.float32), bootstrap, cfg.gamma, cfg.gae_lambda
        )

        # flatten [T, B] -> [N]
        def flat(x):
            return x.reshape((T * B,) + x.shape[2:])

        data = {
            "tobs": jax.tree_util.tree_map(flat, batch.tobs),
            "action": flat(batch.action),
            "log_prob": flat(batch.log_prob),
            "mean": flat(batch.mean),
            "std": flat(batch.std),
            "value": flat(batch.value),
            "advantage": flat(advantage),
            "value_target": flat(value_target),
            "env_ids": jnp.tile(jnp.arange(B, dtype=jnp.int32), T),
        }
        N = T * B
        n_mb = self.num_minibatches
        mb_size = self.mini_batch_size

        grad_fn = jax.grad(self._minibatch_loss, argnums=(0, 1), has_aux=True)

        def epoch_fn(carry, _):
            actor_params, critic_params, actor_opt, critic_opt, key, num_updates, kl_beta = carry
            key, k_perm = jax.random.split(key)
            perm = jax.random.permutation(k_perm, N)[: n_mb * mb_size].reshape(n_mb, mb_size)

            def mb_fn(carry, idx):
                actor_params, critic_params, actor_opt, critic_opt, num_updates, kl_beta = carry
                mb = jax.tree_util.tree_map(lambda x: x[idx], data)
                (g_actor, g_critic), (metrics, kl_beta) = grad_fn(
                    actor_params, critic_params, mb, num_updates, state.initial_entropy, kl_beta
                )
                # pre-clip gradient magnitude (diagnosis instrumentation:
                # collapse/spike signatures — docs/TWO_AGENTS_NOTES.md,
                # ALGO_COMPARISON kl_ppo post-mortem). `_max` aggregates as a
                # true max over the epoch*minibatch stack below.
                gn = optax.global_norm(g_actor)
                metrics["grad_norm_actor"] = gn
                metrics["grad_norm_actor_max"] = gn
                a_up, actor_opt = self.actor_tx.update(g_actor, actor_opt, actor_params)
                c_up, critic_opt = self.critic_tx.update(g_critic, critic_opt, critic_params)
                if lr_scale is not None:
                    # PAPI LR annealing (lr_schedule.step() equivalent) applied
                    # as a multiplicative update scale for actor and critic
                    a_up = jax.tree_util.tree_map(lambda u: u * lr_scale, a_up)
                    c_up = jax.tree_util.tree_map(lambda u: u * lr_scale, c_up)
                actor_params = optax.apply_updates(actor_params, a_up)
                critic_params = optax.apply_updates(critic_params, c_up)
                return (actor_params, critic_params, actor_opt, critic_opt, num_updates + 1, kl_beta), metrics

            (actor_params, critic_params, actor_opt, critic_opt, num_updates, kl_beta), metrics = jax.lax.scan(
                mb_fn, (actor_params, critic_params, actor_opt, critic_opt, num_updates, kl_beta), perm,
                unroll=2,
            )
            return (actor_params, critic_params, actor_opt, critic_opt, key, num_updates, kl_beta), metrics

        carry0 = (
            state.actor_params,
            state.critic_params,
            state.actor_opt,
            state.critic_opt,
            state.key,
            state.num_updates,
            state.kl_beta,
        )
        (actor_params, critic_params, actor_opt, critic_opt, key, num_updates, kl_beta), metrics = jax.lax.scan(
            epoch_fn, carry0, None, length=cfg.ppo_epochs
        )
        if cfg.algo == "kl_ppo" and cfg.kl_beta_interval == "iteration":
            # Schulman (2017) adaptive-KL semantics: one beta update per
            # iteration. The adapt signal is the mean of the LAST epoch's
            # minibatch KLs, each computed before that minibatch's parameter
            # update — so it lags the fully-updated end-of-phase policy by up
            # to one epoch of minibatch steps (Schulman adapts from the KL of
            # the final policy; an extra full-batch forward pass would close
            # the gap but costs a whole batch eval per iteration). Same
            # thresholds/factors/clamp as the per-minibatch path
            # (rl/losses.kl_pen_ppo_loss).
            from ..rl.losses import KL_PEN_BETA_MAX, KL_PEN_BETA_MIN

            kl_final = metrics["kl"][-1].mean()
            kl_beta = jnp.where(
                kl_final > cfg.dtarg * 1.5,
                kl_beta * cfg.kl_increment,
                jnp.where(kl_final < cfg.dtarg / 1.5, kl_beta * cfg.kl_decrement, kl_beta),
            )
            kl_beta = jnp.clip(kl_beta, KL_PEN_BETA_MIN, KL_PEN_BETA_MAX)
        # per-iteration aggregation over the [epochs, minibatches] metric
        # stacks: means, EXCEPT the *_max constraint metrics which aggregate
        # as true maxes — a mean-of-maxes dilutes a single-minibatch KL spike
        # ~(epochs*minibatches)x and hides exactly the instabilities these
        # keys exist to surface (train.py:280-292 logs them per minibatch).
        metrics = {
            k: (v.max() if k.endswith("_max") else v.mean()) for k, v in metrics.items()
        }
        # explained variance (train.py:325)
        var_y = jnp.var(data["value_target"])
        metrics["train/explained_variance"] = 1.0 - jnp.var(data["value_target"] - data["value"]) / jnp.maximum(
            var_y, 1e-8
        )
        new_state = state._replace(
            actor_params=actor_params,
            critic_params=critic_params,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            key=key,
            num_updates=num_updates,
            kl_beta=kl_beta,
        )
        return new_state, metrics

    # -------------------------------------------------------------- full step

    @partial(jax.jit, static_argnums=0)
    def train_iteration(self, state: TrainState) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
        state, batch, collect_stats = self._collect(state)
        state, metrics = self._update(state, batch)
        metrics.update(collect_stats)
        return state, metrics

    # ------------------------------------------------------------------ PAPI

    def papi_init(self, state: TrainState):
        """Seed the PAPI cross-iteration carry (cfg.papi_steps workflow)."""
        from ..rl.projections.papi import papi_init_state

        return papi_init_state(state.actor_params, history=self.cfg.papi_history)

    @partial(jax.jit, static_argnums=0)
    def train_iteration_papi(self, state: TrainState, papi_state):
        """collect + update + `_papi_steps` post-update backtracking
        (papi_projection.py:151-245): one jitted program per iteration.
        Use with proj_type='papi' and a non-contextual-std policy."""
        from ..rl.projections.papi import papi_steps

        state, batch, collect_stats = self._collect(state)
        state, metrics = self._update(state, batch, lr_scale=papi_state.lr_scale)

        T, B = self.cfg.steps_per_batch, self.env.cfg.num_envs

        def flat(x):
            return x.reshape((T * B,) + x.shape[2:])

        tobs = jax.tree_util.tree_map(flat, batch.tobs)
        env_ids = jnp.tile(jnp.arange(B, dtype=jnp.int32), T)
        q = G.DiagGaussian(flat(batch.mean), flat(batch.std))

        def apply_fn(params):
            return self._policy_dist(params, tobs, env_ids)

        new_params, papi_state, anneal, n_backtracks = papi_steps(
            apply_fn,
            state.actor_params,
            papi_state,
            q,
            mean_bound=self.projection.mean_bound,
            cov_bound=self.projection.cov_bound,
            initial_entropy=state.initial_entropy,
            init_std=getattr(self.policy, "init_std", 1.0),
            minimal_std=getattr(self.policy, "minimal_std", 1e-5),
            n_iters=self.cfg.papi_iters,
        )
        papi_state = papi_state._replace(
            lr_scale=papi_state.lr_scale * jnp.where(anneal, self.cfg.papi_lr_decay, 1.0)
        )
        state = state._replace(actor_params=new_params)
        metrics.update(collect_stats)
        metrics["papi/n_backtracks"] = n_backtracks.astype(jnp.float32)
        metrics["papi/lr_scale"] = papi_state.lr_scale
        return state, papi_state, metrics

    # ------------------------------------------------------------------ eval

    @partial(jax.jit, static_argnums=(0, 2, 3))
    def eval_rollout(self, state: TrainState, n_steps: int, deterministic: bool = True):
        """Deterministic (mode) rollout returning mean episode reward
        (AgentBuilder.eval_model equivalent, agent.py:87-101)."""
        env = self.env
        B = env.cfg.num_envs

        def step_fn(carry, _):
            env_state, obs, key, cum, ep_sum, ep_cnt = carry
            key, k = jax.random.split(key)
            _, tobs = obs_norm_step(state.norm, obs, update=False)
            dist = self._policy_dist(state.actor_params, tobs, inference=True)
            action = dist.mean if deterministic else G.sample(k, dist)
            env_state, ts = env.step(env_state, action)
            cum = cum + ts.reward
            ep_sum = ep_sum + jnp.where(ts.done, cum, 0.0).sum()
            ep_cnt = ep_cnt + ts.done.sum()
            cum = jnp.where(ts.done, 0.0, cum)
            return (env_state, ts.obs, key, cum, ep_sum, ep_cnt), None

        key = jax.random.fold_in(state.key, 7)
        env_state = env.reset(key)
        obs = env.observe(env_state)
        carry = (env_state, obs, key, jnp.zeros((B,)), jnp.zeros(()), jnp.zeros((), jnp.int32))
        carry, _ = jax.lax.scan(step_fn, carry, None, length=n_steps)
        ep_sum, ep_cnt = carry[4], carry[5]
        return ep_sum / jnp.maximum(ep_cnt, 1)

    @partial(jax.jit, static_argnums=(0, 2, 4))
    def eval_success(self, state: TrainState, n_steps: int, threshold: float = 0.1, deterministic: bool = True):
        """Success-rate eval for tasks exposing `object_target_distance` info:
        fraction of episode ends whose final distance is under `threshold`,
        plus the mean final distance (per-shape analysis via env.shape_ids)."""
        env = self.env
        B = env.cfg.num_envs

        def step_fn(carry, _):
            env_state, obs, key, succ, dist_sum, ends = carry
            key, k = jax.random.split(key)
            _, tobs = obs_norm_step(state.norm, obs, update=False)
            dist = self._policy_dist(state.actor_params, tobs, inference=True)
            action = dist.mean if deterministic else G.sample(k, dist)
            env_state, ts = env.step(env_state, action)
            d = ts.info["object_target_distance"]
            done_f = ts.done.astype(d.dtype)
            succ = succ + (done_f * (d < threshold)).sum()
            dist_sum = dist_sum + (done_f * d).sum()
            ends = ends + done_f.sum()
            return (env_state, ts.obs, key, succ, dist_sum, ends), None

        key = jax.random.fold_in(state.key, 13)
        env_state = env.reset(key)
        obs = env.observe(env_state)
        carry = (env_state, obs, key, jnp.zeros(()), jnp.zeros(()), jnp.zeros(()))
        carry, _ = jax.lax.scan(step_fn, carry, None, length=n_steps)
        _, _, _, succ, dist_sum, ends = carry
        ends = jnp.maximum(ends, 1.0)
        return {"success_rate": succ / ends, "mean_final_distance": dist_sum / ends}
