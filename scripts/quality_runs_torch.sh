#!/bin/sh
# The port's quality and speed runs on one card, each output in OUT_DIR:
#   1. the headline bench (python -m webdgs_tpu_torch bench) -> bench.json
#   2. scripts/validate_training_torch.py at its defaults -> validate.json
#   3. RESULTS.md capture 10's recipe (scripts/onchip_r5.sh train800) through
#      the port's train command: 48 synthetic 800x600 views of
#      make_synthetic_colmap.py --points 30000 (seed 7), every 8th held out,
#      ITERATIONS (default 30000) iterations -> report.json, train_log.txt,
#      ck30k.npz (also saved every 2000 iterations)
#   4. the bench on that checkpoint -> bench_trained.json
# With RESUME_CKPT a checkpoint of step 3 resumes where it stopped; SEED
# (default 0) seeds step 3's view draws and densify noise (train --seed).
# Exits 1 when any stage failed (each stage's rc is echoed as it ends).
#
# Usage: [SEED=n] sh scripts/quality_runs_torch.sh OUT_DIR [ITERATIONS]
#            [RESUME_CKPT]
set -u
OUT=${1:?usage: quality_runs_torch.sh OUT_DIR [ITERATIONS] [RESUME_CKPT]}
ITERS=${2:-30000}
RESUME=${3:-}
SEED=${SEED:-0}
mkdir -p "$OUT"
stamp() { echo "[$(date -u +%H:%M:%S)] $*"; }
FAILED=""
rc() { echo "$1 rc=$2"; if [ "$2" -ne 0 ]; then FAILED="$FAILED $1"; fi; }

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"

stamp "bench"
python -m webdgs_tpu_torch bench > "$OUT/bench.json" 2> "$OUT/bench.err"
rc bench $?; cat "$OUT/bench.json"

stamp "validate_training_torch.py (defaults)"
python scripts/validate_training_torch.py --out "$OUT/validate.json" \
    > "$OUT/validate_log.txt" 2>&1
rc validate $?; tail -3 "$OUT/validate_log.txt"

TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
DATA=$TMP/scene8
stamp "make_synthetic_colmap.py"
python scripts/make_synthetic_colmap.py "$DATA" --views 48 --width 800 \
    --height 600 --points 30000 > "$OUT/colmap_log.txt" 2>&1
rc colmap $?; tail -1 "$OUT/colmap_log.txt"

stamp "train $ITERS iterations, seed $SEED"
set --
if [ -n "$RESUME" ]; then set -- --resume "$RESUME"; fi
T0=$(date +%s)
python -m webdgs_tpu_torch train \
    --points "$DATA/sparse/0/points3D.bin" \
    --cameras "$DATA/sparse/0/images.bin" "$DATA/sparse/0/cameras.bin" \
    --images "$DATA/images" \
    --iterations "$ITERS" --log-every 1000 --holdout-every 8 \
    --checkpoint-every 2000 --width 800 --height 600 --seed "$SEED" "$@" \
    --out "$OUT/ck30k.npz" --report "$OUT/report.json" \
    > "$OUT/train_log.txt" 2>&1
RC=$?
echo "train wall_s=$(( $(date +%s) - T0 ))"
rc train $RC
tail -4 "$OUT/train_log.txt"

stamp "bench on the trained checkpoint"
WEBDGS_BENCH_CHECKPOINT="$OUT/ck30k.npz" python -m webdgs_tpu_torch bench \
    > "$OUT/bench_trained.json" 2> "$OUT/bench_trained.err"
rc bench_trained $?; cat "$OUT/bench_trained.json"
stamp "done"
if [ -n "$FAILED" ]; then
    echo "failed:$FAILED"
    exit 1
fi
