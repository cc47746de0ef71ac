"""Multi-host SPMD: 2 processes x 4 virtual CPU devices == one 8-device run.

The reference has no multi-host story (single GPU, SURVEY §2.11); this
framework's multi-process path is `jax.distributed.initialize` + the global
env mesh (parallel/multihost.py). This test spawns two REAL processes wired over
a localhost coordinator (Gloo collectives) and drives the actual training
CLI end-to-end in each, then checks the logged metrics match a single-process
8-device run of the same config — multi-host data-parallelism is semantically
a no-op, exactly like tests/test_parallel.py proves for single-process.
"""

import glob
import json
import os
import socket
import subprocess
import sys



REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")

TINY_OVERRIDES = [
    "seed=0",
    "env.num_envs=8",
    "env.kwargs.warmup_steps=0",
    "env.kwargs.episode_length=8",
    "collector.frames_per_batch=64",
    "collector.total_frames=128",
    "algorithm.latent_dim=16",
    "algorithm.num_ori=4",
    "algorithm.objective.mini_batch_size=32",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _read_metrics(log_dir: str) -> list:
    runs = sorted(glob.glob(os.path.join(log_dir, "*", "metrics.jsonl")))
    assert runs, f"no metrics.jsonl under {log_dir}"
    with open(runs[-1]) as f:
        return [json.loads(line) for line in f]


def test_two_process_cli_matches_single_process(tmp_path):
    port = _free_port()
    mh_dir = str(tmp_path / "mh")

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own 4-device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port), mh_dir],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=REPO,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out.decode())
    finally:
        # a wedged distributed init leaves the peer blocked in a collective —
        # never orphan workers holding the coordinator port
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    # only rank 0 logs; both participate in the collective checkpoint save
    mh_metrics = _read_metrics(mh_dir)
    run_dir = os.path.dirname(sorted(glob.glob(os.path.join(mh_dir, "*", "metrics.jsonl")))[-1])
    assert glob.glob(os.path.join(run_dir, "checkpoints", "*")), "no checkpoint written"

    # pod-train -> single-host eval: the collectively-saved checkpoint must
    # restore and evaluate in ONE process (the real play.py workflow after a
    # pod run; requires the shared-filesystem layout this test naturally has)
    from geometry_rl_tpu.train.play import main as play_main

    play_main(["--run-dir", run_dir, "--checkpoint", "checkpoints",
               "--episodes-steps", "8", "--num-envs", "4"])
    with open(os.path.join(run_dir, "eval.json")) as f:
        ev = json.load(f)
    assert all(v == v for v in ev.values() if isinstance(v, float)), ev

    # reference: same config, this process's 8 virtual devices (one process)
    from geometry_rl_tpu.train.cli import main

    ref_dir = str(tmp_path / "ref")
    main(["--config", "rigid_insertion_multi_hepi_trpl", "--override"]
         + TINY_OVERRIDES + [f"logger.log_dir={ref_dir}"])
    ref_metrics = _read_metrics(ref_dir)

    assert len(mh_metrics) == len(ref_metrics) == 2
    for row, (row_mh, row_ref) in enumerate(zip(mh_metrics, ref_metrics)):
        # Cross-process (Gloo) reductions reassociate f32 sums; after an
        # optimizer step that noise amplifies through the params, so the
        # first iteration is checked tightly and later ones loosely.
        atol, rtol = (2e-4, 1e-3) if row == 0 else (1e-3, 2e-2)
        for k, v_ref in row_ref.items():
            if k in ("wall_time", "train/iteration_time"):
                continue
            if k.endswith("_max") or k.endswith("_min") or k.startswith("grad_norm"):
                # order statistics (max/min set by ONE sample) and global
                # gradient norms (sqrt of a sum over EVERY parameter — the
                # full parameter-space Gloo reassociation noise lands in one
                # scalar, measured ~1.5e-3 relative) are not averaged down
                # like the mean metrics are
                a, r = (1e-3, 2e-2)
            else:
                a, r = atol, rtol
            v_mh = row_mh[k]
            if v_ref != v_ref:  # NaN on both sides is fine
                assert v_mh != v_mh, k
                continue
            assert abs(v_mh - v_ref) <= a + r * abs(v_ref), (row, k, v_mh, v_ref)


def test_multihost_binds_each_process_to_one_card(monkeypatch):
    import jax

    from geometry_rl_tpu.parallel import multihost

    for k, v in {"GEOMRL_COORDINATOR": "localhost:1234", "GEOMRL_NUM_PROCESSES": "4",
                 "GEOMRL_PROCESS_ID": "2"}.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(kw))
    assert multihost.maybe_initialize_distributed() is True
    assert seen == {"coordinator_address": "localhost:1234", "num_processes": 4,
                    "process_id": 2, "local_device_ids": [2]}


def test_single_process_skips_distributed_init(monkeypatch):
    from geometry_rl_tpu.parallel import multihost

    monkeypatch.delenv("GEOMRL_COORDINATOR", raising=False)
    assert multihost.maybe_initialize_distributed() is False
