#!/bin/bash
# Fold-parallel CV benchmark of the port: nested 5x3 (15 folds) and
# exhaustive 10x9 (90 pairs) fusion CV on the card, sequential against
# --fold-parallel, with cached embeddings and on raw modalities, at the
# hospital cohort's scale (n=244), 8 epochs on both sides (the
# comparison is the harness's overhead, not convergence). The same 8 runs
# as the JAX package's ecgmm_tpu/tools/bench_cv.sh, through
# `python -m ecgmm_torch.train.cv`. Prints one timing line per run; each
# run's output goes to build/cvbench/ under the checkout's root.
#
#   bash ecgmm_torch/tools/bench_cv.sh
set -u
cd "$(dirname "$0")/../.."
LOG_DIR=build/cvbench
mkdir -p "$LOG_DIR"
run() {
  local tag="$1"; shift
  local t0=$(date +%s.%N)
  "$@" > "${LOG_DIR}/cvbench_${tag}.log" 2>&1
  local rc=$?
  local t1=$(date +%s.%N)
  echo "CVBENCH ${tag} rc=${rc} wall_s=$(awk -v a="$t0" -v b="$t1" 'BEGIN{printf "%.1f", b-a}')"
}
B="python -m ecgmm_torch.train.cv"
N="--n-synth 244 --epochs 8"
run nested_seq_cached   $B nested --preset fusion $N --cache-embeddings
run nested_par_cached   $B nested --preset fusion $N --cache-embeddings --fold-parallel
run nested_seq_raw      $B nested --preset fusion $N
run nested_par_raw      $B nested --preset fusion $N --fold-parallel
run exh_seq_cached      $B exhaustive --preset fusion $N --k 10 --cache-embeddings
run exh_par_cached      $B exhaustive --preset fusion $N --k 10 --cache-embeddings --fold-parallel
run exh_seq_raw         $B exhaustive --preset fusion $N --k 10
run exh_par_raw         $B exhaustive --preset fusion $N --k 10 --fold-parallel
