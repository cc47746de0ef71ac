"""Device-mesh sharding: the env axis is the data-parallel axis.

The reference is single-process/single-GPU (SURVEY.md §2.11) — its only
parallelism is N PhysX envs in lockstep. Here the env axis shards across
devices (the cards of a host, joined by NVLink, or of several hosts): every [B, ...] array (scene state, observations,
rollout batches) is sharded on B; parameters, optimizer state, and normalizer
stats are replicated. Gradients and metric reductions inside the jitted train
step become psums that XLA inserts automatically from the sharding
annotations (no hand-written collectives needed at this model scale —
latent 64 needs no TP/PP/SP, documented N/A per SURVEY §2.11).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (env) axis."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _is_env_batched(x: Any, num_envs: int) -> bool:
    return hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == num_envs


def _put_global(x: Any, sharding: NamedSharding):
    """Place one leaf under `sharding`, multi-process aware.

    Single process: plain device_put. Multi-process: every
    process computes the FULL array identically (same seed, deterministic
    init), so build the global jax.Array from this process's row block —
    `jax.devices()` orders process 0's devices first, so the env axis maps to
    contiguous per-process blocks.
    """
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    if sharding.spec and len(sharding.spec) >= 1 and sharding.spec[0] == ENV_AXIS:
        n = jax.process_count()
        if x.shape[0] % n != 0:
            raise ValueError(
                f"env axis {x.shape[0]} not divisible by process count {n}"
            )
        per = x.shape[0] // n
        i = jax.process_index()
        local = x[i * per : (i + 1) * per]
    else:
        local = x
    return jax.make_array_from_process_local_data(sharding, local, x.shape)


def replicate_pytree(tree: Any, mesh: Mesh) -> Any:
    """Replicate every leaf over the (possibly multi-host) mesh — for
    auxiliary carries like PAPIState that must enter a global-mesh jit."""
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: _put_global(x, rep), tree)


def shard_env_pytree(tree: Any, mesh: Mesh, num_envs: int) -> Any:
    """Place every [num_envs, ...] leaf sharded over the env axis; everything
    else replicated. Applied to EnvState / obs pytrees before the jitted
    train step so XLA propagates the layout through the whole program.

    Leaves whose field/dict name is "key" are always replicated: a PRNG key
    is uint32[2] (or [4]), so with num_envs == 2 the shape[0] heuristic alone
    would silently shard the key across devices and change RNG semantics."""
    env_s = env_sharding(mesh)
    rep = replicated(mesh)

    def _leaf_name(path) -> str:
        if not path:
            return ""
        last = path[-1]
        return getattr(last, "name", None) or str(getattr(last, "key", ""))

    def place(path, x):
        if _leaf_name(path) != "key" and _is_env_batched(x, num_envs):
            return _put_global(x, env_s)
        return _put_global(x, rep)

    return jax.tree_util.tree_map_with_path(place, tree)


def shard_train_state(state: Any, mesh: Mesh, num_envs: int) -> Any:
    """TrainState placement: env_state/obs sharded on env; params, optimizer
    state, normalizer stats, counters replicated."""
    rep = replicated(mesh)
    put_rep = lambda t: jax.tree_util.tree_map(lambda x: _put_global(x, rep), t)
    return state._replace(
        actor_params=put_rep(state.actor_params),
        critic_params=put_rep(state.critic_params),
        actor_opt=put_rep(state.actor_opt),
        critic_opt=put_rep(state.critic_opt),
        norm=put_rep(state.norm),
        env_state=shard_env_pytree(state.env_state, mesh, num_envs),
        obs=shard_env_pytree(state.obs, mesh, num_envs),
        key=put_rep(state.key),
        num_updates=put_rep(state.num_updates),
        initial_entropy=put_rep(state.initial_entropy),
        kl_beta=put_rep(state.kl_beta),  # scalar (or None for trpl/ppo)
    )
