"""Checkpoint save/restore: whole-state round trip + forward compatibility
(train/checkpoint.py; replaces train.py:335-368 torch.save dicts)."""

import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometry_rl_tpu.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint


class OldState(NamedTuple):
    params: Any
    counter: jnp.ndarray


class NewState(NamedTuple):
    params: Any
    counter: jnp.ndarray
    extra: jnp.ndarray  # field added after the checkpoint was written


def test_round_trip(tmp_path):
    d = str(tmp_path / "ckpt")
    state = OldState(params={"w": jnp.arange(4.0)}, counter=jnp.asarray(7, jnp.int32))
    save_checkpoint(d, 3, state)
    assert latest_step(d) == 3
    template = OldState(params={"w": jnp.zeros(4)}, counter=jnp.asarray(0, jnp.int32))
    restored = restore_checkpoint(d, template)
    np.testing.assert_array_equal(np.asarray(restored.params["w"]), np.arange(4.0))
    assert int(restored.counter) == 7


def test_forward_compatible_restore(tmp_path):
    """A checkpoint written before a TrainState field existed restores into
    the extended structure, keeping the template value for the new field."""
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 0, OldState(params={"w": jnp.ones(3) * 2}, counter=jnp.asarray(5, jnp.int32)))
    template = NewState(
        params={"w": jnp.zeros(3)},
        counter=jnp.asarray(0, jnp.int32),
        extra=jnp.asarray(1.25),
    )
    restored = restore_checkpoint(d, template)
    np.testing.assert_array_equal(np.asarray(restored.params["w"]), 2 * np.ones(3))
    assert int(restored.counter) == 5
    assert float(restored.extra) == 1.25  # template default preserved


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), OldState(params={}, counter=jnp.asarray(0)))


def test_bfloat16_and_int_leaves_round_trip(tmp_path):
    d = str(tmp_path / "ckpt")
    state = OldState(params={"w": jnp.arange(5.0, dtype=jnp.bfloat16)}, counter=jnp.asarray(-3, jnp.int32))
    save_checkpoint(d, 0, state)
    restored = restore_checkpoint(d, OldState(params={"w": jnp.zeros(5, jnp.bfloat16)}, counter=jnp.asarray(0, jnp.int32)))
    assert restored.params["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(restored.params["w"], np.float32), np.arange(5.0))
    assert int(restored.counter) == -3


def test_only_the_newest_checkpoints_are_kept(tmp_path):
    from geometry_rl_tpu.train.checkpoint import MAX_TO_KEEP

    d = str(tmp_path / "ckpt")
    state = OldState(params={"w": jnp.zeros(2)}, counter=jnp.asarray(0, jnp.int32))
    for step in range(MAX_TO_KEEP + 3):
        save_checkpoint(d, step, state._replace(counter=jnp.asarray(step, jnp.int32)), metrics={"reward": 1.0})
    kept = sorted(int(s) for s in os.listdir(d))
    assert kept == list(range(3, MAX_TO_KEEP + 3))
    assert latest_step(d) == MAX_TO_KEEP + 2
    assert int(restore_checkpoint(d, state, step=4).counter) == 4


def test_restore_selected_fields_keeps_the_rest(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, NewState(params={"w": jnp.ones(3)}, counter=jnp.asarray(9, jnp.int32), extra=jnp.ones(7)))
    template = NewState(params={"w": jnp.zeros(3)}, counter=jnp.asarray(0, jnp.int32), extra=jnp.zeros(2))
    restored = restore_checkpoint(d, template, fields=("params",))
    np.testing.assert_array_equal(np.asarray(restored.params["w"]), np.ones(3))
    assert int(restored.counter) == 0 and restored.extra.shape == (2,)  # not restored
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, template)  # extra's stored shape differs
