"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on `xla_force_host_platform_device_count=8`
CPU devices; tests that need a GPU carry the `gpu` marker and skip here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

import pytest  # noqa: E402

_last_module = [None]


@pytest.fixture(autouse=True)
def _clear_xla_cache_per_module(request):
    """XLA CPU's JIT compiler segfaults nondeterministically when the whole
    suite's compile cache accumulates (first seen round 1 at
    test_rope_trainer_end_to_end, round 2 at test_rope_graph_builder — the
    crash point moves as tests are added). Clearing the in-process jax
    caches at every module boundary bounds the accumulated state while
    keeping intra-module cache reuse."""
    mod = request.module.__name__
    if mod != _last_module[0]:
        _last_module[0] = mod
        jax.clear_caches()
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (chip_smoke.py runs these checks on the card)"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the card")
