"""XLA settings shared by the entry points (train/play/bc CLIs, bench.py,
chip_smoke.py). Call `configure_xla()` before JAX starts its backend.

Compile cache: compiling the flagship training program takes tens of
seconds. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and
nothing is set here. Otherwise the cache lives at a fixed path inside the
checkout, `<repo>/.jax_cache`: the path is part of what a later run looks
up, so it never depends on a temp dir, a pid or the time.

GPU flags: with split-K GEMM autotuning on, XLA fails to compile the update
step's weight gradients ("Failed to compute symbolic tile" for the
[33000, 64] x [33000, 64] contraction of the critic's 1000 x 33 nodes), so
it is off. The flags are appended to XLA_FLAGS, which XLA reads when the
backend starts.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
XLA_GPU_FLAGS = ("--xla_gpu_enable_split_k_autotuning=false",)


def configure_xla() -> str:
    """Set the XLA flags and the compile cache; returns the cache dir."""
    flags = os.environ.get("XLA_FLAGS", "")
    missing = [f for f in XLA_GPU_FLAGS if f.split("=")[0] not in flags]
    if missing:
        os.environ["XLA_FLAGS"] = " ".join([flags, *missing]).strip()
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
