"""Multi-process runtime initialization.

The reference is single-process/single-GPU (SURVEY.md §2.11); scale-out there
means SLURM array jobs of independent runs (docker/container.sh). Here
scale-out is ONE SPMD program over every card: each process runs this same
CLI, `jax.distributed.initialize` wires the processes into one runtime, and
the env axis shards over the GLOBAL device mesh (parallel/mesh.py).

A launch sets GEOMRL_COORDINATOR=host:port, GEOMRL_NUM_PROCESSES and
GEOMRL_PROCESS_ID for every process. All processes run on one host, and each
owns the card whose index is its process id. On CPU the card binding has no
effect.

Verified end-to-end on 2 processes x 4 virtual CPU devices with Gloo
collectives (tests/test_multihost.py): one sharded train_iteration matches
the single-process 8-device run.
"""

from __future__ import annotations

import os

import jax


def maybe_initialize_distributed() -> bool:
    """Initialize the distributed runtime when this is one process of a
    multi-process launch; no-op (returns False) for single-process runs.

    MUST run before any JAX computation touches the backend (the local
    backend commits to single-process mode on first use).
    """
    coord = os.environ.get("GEOMRL_COORDINATOR")
    if not coord:
        return False
    process_id = int(os.environ["GEOMRL_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["GEOMRL_NUM_PROCESSES"]),
        process_id=process_id,
        local_device_ids=[process_id],
    )
    return True


def is_main_process() -> bool:
    """True on the process that should own logging/printing (rank 0)."""
    return jax.process_index() == 0
