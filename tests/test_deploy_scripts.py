"""Smoke tests for the deploy scripts' --dry-run / DRY_RUN=1 modes.

The scripts themselves can't execute here (no SLURM daemon, no GPU), but their argument handling, flag composition and usage errors are
testable: dry-run prints the exact command that would run (VERDICT r2
"keep them smoke-testable so CI can at least parse/flag-check them")."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cmd, **env):
    return subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True,
        env={**os.environ, **{k: str(v) for k, v in env.items()}},
    )


def test_launch_gpu_dry_run():
    r = run(["bash", "deploy/launch_gpu.sh", "--dry-run",
             "rigid_insertion_multi_hepi_trpl", "env.num_envs=8", "seed=3"])
    assert r.returncode == 0, r.stderr
    out = r.stdout.strip()
    assert out.startswith("DRY-RUN: python -m geometry_rl_tpu.train.cli")
    assert "--config rigid_insertion_multi_hepi_trpl" in out
    assert "--override env.num_envs=8 seed=3" in out


def test_launch_gpu_dry_run_env_var_and_no_overrides():
    r = run(["bash", "deploy/launch_gpu.sh", "cloth_hanging_multi_hepi_trpl"], DRY_RUN=1)
    assert r.returncode == 0, r.stderr
    assert "--override" not in r.stdout  # no empty --override tail


def test_launch_gpu_usage_error():
    r = run(["bash", "deploy/launch_gpu.sh", "--dry-run"])
    assert r.returncode != 0
    assert "usage" in r.stderr


def test_launch_gpu_refuses_without_gpu():
    # outside a dry run the launcher checks for a card before starting
    r = run(["bash", "deploy/launch_gpu.sh", "rigid_insertion_multi_hepi_trpl"],
            PATH="/usr/bin:/bin")
    assert r.returncode != 0
    assert "no GPU visible" in r.stderr


def test_slurm_job_dry_run():
    r = run(["bash", "deploy/slurm_job.sbatch", "rope_closing_hepi_trpl"],
            DRY_RUN=1, SLURM_ARRAY_TASK_ID=7,
            EXTRA_OVERRIDES="collector.total_frames=1000")
    assert r.returncode == 0, r.stderr
    out = r.stdout.strip()
    assert "--config rope_closing_hepi_trpl" in out
    assert "seed=7" in out
    assert "logs/geometry_rl_tpu/rope_closing_hepi_trpl_seed7" in out
    assert "collector.total_frames=1000" in out


def test_slurm_job_default_seed():
    r = run(["bash", "deploy/slurm_job.sbatch", "rope_closing_hepi_trpl"], DRY_RUN=1)
    assert r.returncode == 0, r.stderr
    assert "seed=0" in r.stdout


def test_slurm_job_requests_one_gpu():
    with open(os.path.join(REPO, "deploy", "slurm_job.sbatch")) as f:
        assert "#SBATCH --gres=gpu:1" in f.read().splitlines()


@pytest.mark.parametrize("script", ["launch_gpu.sh", "slurm_job.sbatch"])
def test_bash_syntax(script):
    r = run(["bash", "-n", os.path.join("deploy", script)])
    assert r.returncode == 0, r.stderr
