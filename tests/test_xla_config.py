"""XLA settings of the entry points (geometry_rl_tpu/xla_config.py):
compile-cache placement and the GPU flags."""

import os

import jax
import pytest

from geometry_rl_tpu import xla_config


@pytest.fixture
def restore_xla_state(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # restored afterwards
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_defaults_to_fixed_dir_in_checkout(monkeypatch, restore_xla_state):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = xla_config.configure_xla()
    root = os.path.dirname(os.path.dirname(os.path.abspath(xla_config.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert xla_config.configure_xla() == path  # stable across calls


def test_cache_env_var_wins_and_code_sets_nothing(monkeypatch, tmp_path, restore_xla_state):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert xla_config.configure_xla() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads the variable itself


def test_gpu_flags_appended_once_and_user_value_kept(monkeypatch, tmp_path, restore_xla_state):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    xla_config.configure_xla()
    xla_config.configure_xla()
    flags = os.environ["XLA_FLAGS"].split()
    assert flags == ["--xla_force_host_platform_device_count=8", "--xla_gpu_enable_split_k_autotuning=false"]
    monkeypatch.setenv("XLA_FLAGS", "--xla_gpu_enable_split_k_autotuning=true")
    xla_config.configure_xla()
    assert os.environ["XLA_FLAGS"] == "--xla_gpu_enable_split_k_autotuning=true"
