#!/usr/bin/env bash
# Launch a training run on a GPU host (the container.sh start+enter+train role).
#
#   deploy/launch_gpu.sh [--dry-run] <config-name> [overrides...]
#
# One process drives every card it can see; CUDA_VISIBLE_DEVICES picks them.
# --dry-run (or DRY_RUN=1) prints the command instead of executing it, so CI
# can smoke-test argument handling without hardware. Outside a dry run the
# script refuses to start when no GPU is visible.
set -euo pipefail
DRY_RUN="${DRY_RUN:-0}"
if [ "${1:-}" = "--dry-run" ]; then DRY_RUN=1; shift; fi
CONFIG="${1:?usage: launch_gpu.sh [--dry-run] <config-name> [overrides...]}"
shift || true
CMD=(python -m geometry_rl_tpu.train.cli --config "$CONFIG")
if [ "$#" -gt 0 ]; then CMD+=(--override "$@"); fi
if [ "$DRY_RUN" = "1" ]; then
  echo "DRY-RUN: ${CMD[*]}"
  exit 0
fi
if ! nvidia-smi -L 2>/dev/null | grep -q "^GPU"; then
  echo "launch_gpu.sh: no GPU visible (nvidia-smi -L lists none)" >&2
  exit 1
fi
exec "${CMD[@]}"
