"""Cloth solver A/B on the GPU: the fused position-solve kernel
(sim/pallas_cloth.py) against the XLA solver (sim/xpbd.py).

1. Parity: from the same states, one env step (decimation substeps) of the
   kernel against the XLA solver, over `--parity-steps` steps at 256 envs;
   largest particle and body position difference (gate: 2e-4).
2. Speed: cloth_hanging HEPi collection env-steps/s with bench.py's loop, at
   100 and 256 envs, solvers in the order XLA, kernel, kernel, XLA, each with
   its own compile and warm-up call.

    python scripts/cloth_solver_timing.py [--parity-steps 10] [--scan-steps 50]

Prints one JSON line.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parity-steps", type=int, default=10)
    ap.add_argument("--scan-steps", type=int, default=50)
    args = ap.parse_args()

    import bench
    from chip_smoke import cloth_kernel_parity
    from geometry_rl_tpu.xla_config import configure_xla

    configure_xla()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("cloth_solver_timing.py measures the GPU; no GPU found")
    card = bench.card_name_and_power_limit()
    print(card, flush=True)

    parity = cloth_kernel_parity(steps=args.parity_steps)
    print("parity", parity, flush=True)
    rates = {}
    for num_envs in (100, 256):
        for solver in (False, True, True, False):
            name = f"{'kernel' if solver else 'xla'}_{num_envs}"
            r = bench.bench_collection(
                "cloth_hanging", num_envs, args.scan_steps, env_kwargs={"use_pallas_solver": solver}
            )
            rates.setdefault(name, []).append(r)
            print(name, r, flush=True)
    print(json.dumps({"card": card, "device_kind": jax.devices()[0].device_kind,
                      "parity_max_abs": parity, "collection_env_steps_per_s": rates}))


if __name__ == "__main__":
    main()
