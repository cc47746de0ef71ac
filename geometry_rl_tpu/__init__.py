"""geometry_rl_tpu — geometry-aware RL framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
thobotics/geometry_rl (ICLR 2025, "Geometry-aware RL for Manipulation of
Varying Shapes and Deformable Objects"): batched manipulation simulation
(rigid + XPBD deformables), SE(3)-equivariant graph policies (HEPi / EMPN),
and trust-region projected PPO (TRPL) — rollout, advantage and update all
on-device under a single jit.

Layer map (mirrors reference layers, see SURVEY.md §1):
  sim/      — batched physics (replaces Isaac Sim / geometry_orbit, L0)
  envs/     — task layer: scenes, obs/reward/reset terms, registry (L1-L2)
  graphs/   — obs -> padded heterogeneous graphs (L3)
  models/   — HEPi, PonitaGCN/EMPN, Transformer, GCN, DeepSets (L4)
  rl/       — Gaussian policies, projections, TRPL/PPO losses, GAE (L5)
  train/    — on-device training loop, checkpointing, logging (L6-L7)
  parallel/ — device-mesh sharding utilities (env-axis data parallelism)
  ops/      — hot ops: segment ops, projections, the fused cloth solve
  utils/    — geometry math (quaternions, transforms, S2 grids)
"""

__version__ = "0.1.0"

# Lazy re-exports (PEP 562). Importing the framework creates jnp constants,
# which initializes the XLA backend — but `jax.distributed.initialize` (the
# multi-host path, parallel/multihost.py) must run BEFORE backend init. A
# lazy package root keeps `python -m geometry_rl_tpu.train.cli` light until
# the CLI has had the chance to wire up the distributed runtime.
_LAZY = {
    "load_config": ".config",
    "trainer_from_config": ".config",
    "make_env": ".envs",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name], __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
