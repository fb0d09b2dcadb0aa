#!/usr/bin/env bash
# Stage-1 training launcher (counterpart of the reference's accelerate-launch
# wrapper). Usage: -c config [-w work_dir] [-d devices]
#   -d: comma-separated GPU ids to use (sets CUDA_VISIBLE_DEVICES)
set -euo pipefail

CONFIG=""
WORK_DIR="work_dir"
EXTRA_ARGS=()

while getopts "c:w:d:" opt; do
  case $opt in
    c) CONFIG=$OPTARG ;;
    w) WORK_DIR=$OPTARG ;;
    d) export CUDA_VISIBLE_DEVICES=$OPTARG ;;
    *) echo "usage: $0 -c config [-w work_dir] [-d devices]"; exit 1 ;;
  esac
done
[ -n "$CONFIG" ] || { echo "config required (-c)"; exit 1; }

REPO_ROOT="$(cd "$(dirname "$0")/.." && pwd)"
# JAX SPMD: one process drives all visible GPUs (the default mesh puts them
# all on the data axis); multi-host runs launch this script once per host
# with JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID set.
export PYTHONPATH="${REPO_ROOT}:${PYTHONPATH:-}"
exec python "${REPO_ROOT}/scripts/train.py" --config "$CONFIG" --work_dir "$WORK_DIR" "${EXTRA_ARGS[@]}"
