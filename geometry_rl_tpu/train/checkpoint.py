"""Checkpoint / resume: one `.npz` of the flattened state per step.

Replaces the reference's torch.save dict of {env VecNorm state, actor,
critic, reward} (examples/torchrl/train.py:335-368) and its fragile
recursively_merge_dict restore (train.py:99-102): here the WHOLE TrainState
pytree — params, optimizer state, normalizer stats, env state, RNG, update
counter — is one checkpoint, so resume continues optimization exactly (the
reference dropped optimizer state and collector counters; SURVEY.md §5).

Layout: `<directory>/<step>/state.npz`, one array per leaf keyed by its tree
path (`jax.tree_util.keystr`), plus `metrics.json` when metrics are given.
The newest `MAX_TO_KEEP` steps are kept. In a multi-process run every process
takes part in gathering the sharded leaves and process 0 writes.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

MAX_TO_KEEP = 5
_STATE_FILE = "state.npz"


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils

        leaf = multihost_utils.process_allgather(leaf, tiled=True)
    arr = np.asarray(leaf)
    # npz has no bfloat16: store its bits, the template's dtype restores it
    return arr.view(np.uint16) if arr.dtype == jnp.bfloat16 else arr


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d)
        for d in os.listdir(directory)
        if d.isdigit() and os.path.isfile(os.path.join(directory, d, _STATE_FILE))
    )


def save_checkpoint(directory: str, step: int, state: Any, metrics: Optional[dict] = None) -> None:
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {jax.tree_util.keystr(path): _host_array(leaf) for path, leaf in leaves}
    if jax.process_index() == 0:
        step_dir = os.path.join(os.path.abspath(directory), str(step))
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, "state.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(step_dir, _STATE_FILE))
        if metrics is not None:
            with open(os.path.join(step_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        for old in _steps(directory)[:-MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(directory, str(old)))
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(f"checkpoint {directory} {step}")


def restore_checkpoint(
    directory: str, state: Any, step: Optional[int] = None, fields: Optional[tuple] = None
) -> Any:
    """Restore into the structure of `state` (a template TrainState from
    `trainer.init`); each restored leaf takes the template leaf's sharding.

    `fields`: restore only these TrainState fields, keeping the template's
    value for the rest — used by play.py when evaluating with a different
    env count than training (env-sized leaves like env_state/obs cannot be
    restored into a reshaped template; params/normalizer are env-independent).

    Forward-compatible with checkpoints written before fields were added to
    TrainState: leaves absent from the checkpoint keep the template's
    (freshly initialized) value."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint found in {directory}")
    with np.load(os.path.join(directory, str(step), _STATE_FILE)) as f:
        stored = {k: f[k] for k in f.files}

    def restore(path, leaf):
        key = jax.tree_util.keystr(path)
        if key not in stored:
            return leaf
        if fields is not None and getattr(path[0], "name", None) not in fields:
            return leaf
        value = stored[key]
        dtype = np.dtype(leaf.dtype)
        if value.dtype != dtype and value.dtype.itemsize == dtype.itemsize and value.dtype.kind == "u":
            value = value.view(dtype)
        if value.shape != np.shape(leaf):
            raise ValueError(f"checkpoint leaf {key} has shape {value.shape}, the template {np.shape(leaf)}")
        if isinstance(leaf, jax.Array):
            return jax.device_put(value.astype(dtype), leaf.sharding)
        return value.astype(dtype)

    return jax.tree_util.tree_map_with_path(restore, state)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None
