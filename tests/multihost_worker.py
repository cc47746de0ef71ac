"""One process of a multi-host CLI launch (spawned by tests/test_multihost.py).

argv: <process_id> <num_processes> <coordinator_port> <log_dir>
Each worker gets 4 virtual CPU devices; together they form one global mesh
and run the real training CLI end-to-end (distributed init -> mesh sharding
-> train iterations -> checkpoint save).
"""

import os
import sys

pid, nproc, port, log_dir = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["GEOMRL_COORDINATOR"] = f"localhost:{port}"
os.environ["GEOMRL_NUM_PROCESSES"] = nproc
os.environ["GEOMRL_PROCESS_ID"] = pid

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geometry_rl_tpu.train.cli import main  # noqa: E402

main(
    [
        "--config",
        "rigid_insertion_multi_hepi_trpl",
        "--override",
        "seed=0",
        "env.num_envs=8",
        "env.kwargs.warmup_steps=0",
        "env.kwargs.episode_length=8",
        "collector.frames_per_batch=64",
        "collector.total_frames=128",
        "algorithm.latent_dim=16",
        "algorithm.num_ori=4",
        "algorithm.objective.mini_batch_size=32",
        f"logger.log_dir={log_dir}",
    ]
)
assert jax.process_count() == int(nproc), jax.process_count()
print(f"[worker {pid}] done, global devices = {jax.device_count()}", flush=True)
