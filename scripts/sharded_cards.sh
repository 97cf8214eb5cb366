#!/bin/sh
# The tile-sharded layer across the cards of one host, one process per
# card under torchrun (python -m torch.distributed.run):
#   1. cli fit --sharded at c3's 1024x1024 (sphere_grid_scene(8)) on
#      culled_pallas, cull tile 64, 3 Adam steps: each rank prints the card
#      it built its scene on, and every rank's losses must agree;
#   2. cli scale on c3_grid64, engine pallas, render and step, over
#      1, 2, ... N cards: Mrays/s and the efficiency against one card.
# The kernels are built once first, so that the ranks load one build.
#
# Usage: sh scripts/sharded_cards.sh [N_CARDS] [OUT_DIR]
# (defaults: 4 cards, chiprun_out/sharded_cards). Each command's output is
# kept in OUT_DIR; the script exits non-zero if any command fails.
set -eu
N=${1:-4}
OUT=${2:-chiprun_out/sharded_cards}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$OUT/cards.txt"
python -c 'from openglraytracer_tpu_torch import kernels; kernels.library()'
RUN="python -m torch.distributed.run --nproc-per-node $N \
     --master-addr 127.0.0.1 --master-port 29511"
$RUN -m openglraytracer_tpu_torch.cli fit --sharded --grid-side 8 \
    --width 1024 --height 1024 --steps 3 --engine culled_pallas \
    --cull-tile 64 > "$OUT/fit.log" 2>&1 || { tail -50 "$OUT/fit.log"; exit 1; }
grep -E '^(sharded|fit):' "$OUT/fit.log"
n_cards=$(grep -c '^sharded:' "$OUT/fit.log")
n_distinct=$(grep '^sharded:' "$OUT/fit.log" | sed 's/.* on //' | sort -u | wc -l)
n_losses=$(grep '^fit:' "$OUT/fit.log" | sed 's/, [0-9.]*s$//' | sort -u | wc -l)
echo "ranks $n_cards on $n_distinct distinct cards; distinct loss lines $n_losses"
[ "$n_cards" -eq "$N" ] && [ "$n_distinct" -eq "$N" ] && [ "$n_losses" -eq 1 ]
for mode in render step; do
    $RUN -m openglraytracer_tpu_torch.cli scale --scene c3_grid64 \
        --engine pallas --mode "$mode" --iters 10 \
        --json "$OUT/scale_$mode.json" > "$OUT/scale_$mode.log" 2>&1 \
        || { tail -50 "$OUT/scale_$mode.log"; exit 1; }
    grep -v '^\(W\|\*\)' "$OUT/scale_$mode.log" | tail -12
done
