#!/usr/bin/env bash
# The int8 board-agreement gate read on a checkpoint that the port trains
# from random init, on data generated in the repository. Run from the
# repository root on a machine with one CUDA GPU:
#
#   bash chess_vision_tpu_torch/experiments/gate_recipe.sh [OUT]
#
# Each step's output goes to OUT/<step>.log (default OUT: runs_gate),
# its seconds and exit code to OUT/steps.txt; a step that fails does not stop
# the later ones that do not need it, and the script exits non-zero if any
# step failed. GATE_CONFIG names the generator's config (default
# gate_datagen.yaml beside this script); the split directories are read from
# it. The sizes are the gate's own and are not settings: 4 epochs, 64
# calibration boards, the 4,096 test boards, all three int8 layouts, both
# input forms. The checkpoints (~1 GB each) go to checkpoints_gate/ and
# checkpoints_gate_dc/, outside OUT.
#
#  1. data      python -m chess_vision_tpu.datagen.generate --config
#               GATE_CONFIG (the JAX package's generator, used as a tool;
#               test_random, the first split, times 1,000 boards)
#  2. train     python -m chess_vision_tpu_torch.train: configs/vit.yaml with
#               model.pretrained=false, batch 128, lr 2e-4, 4 epochs
#               (experiments/EXPERIMENTS.md run 04's values), OOD set
#               test_random
#  3. evaluate  python -m chess_vision_tpu_torch.evaluate on best.ckpt over
#               the 4,096 test boards
#  4. int8_eval python -m chess_vision_tpu_torch.experiments.int8_eval
#               --calib 64 under CHESS_VISION_INT8_LAYOUT=block, flat and
#               fused, each with --mode rgb and --mode ycbcr420
#  5. int8_gate python -m chess_vision_tpu_torch.experiments.int8_gate: per
#               layout, the int8 kernels and their plain versions against
#               bf16, and each board where any two of them disagree, square
#               by square; then the int8 scheme with one choice changed at a
#               time (the XLA-form block, the erf GELU, no calibration,
#               4:2:0 input)
#  6. smoke     python3 chip_smoke.py --checkpoint best.ckpt --images
#               <test split> --keep-going: each check's reading on the
#               trained weights and real boards
#  7. train_device_cache  the training of step 2 on the packed transport,
#               the corpus (train, val and OOD) held on the card
#               (data.device_cache=auto engages: ~4.7 GiB), no host cache
#  8. int8_eval_device_cache  int8_eval --mode ycbcr420 under the block
#               layout on step 7's best checkpoint: a model trained and
#               served on 4:2:0 planes
set -u
here=$(cd "$(dirname "$0")" && pwd)
out=${1:-runs_gate}
config=${GATE_CONFIG:-$here/gate_datagen.yaml}
ckpt_dir=checkpoints_gate
dc_dir=checkpoints_gate_dc
split_dir() {  # split_dir NAME: the directory GATE_CONFIG writes split NAME to
  python3 -c 'import sys, yaml
print(yaml.safe_load(open(sys.argv[1]))["splits"][sys.argv[2]]["dir"])' \
    "$config" "$1"
}
train_dir=$(split_dir train) && test_dir=$(split_dir test) \
  && ood_dir=$(split_dir test_random) || exit 1
mkdir -p "$out"
: > "$out/steps.txt"
failed=0

step() {  # step NAME COMMAND...: run it, log it, record seconds and exit code
  local name=$1
  shift
  local t0 rc
  t0=$(date +%s.%N)
  echo "== $name: $*" | tee -a "$out/steps.txt"
  "$@" > "$out/$name.log" 2>&1
  rc=$?
  printf '%s rc=%d seconds=%.1f\n' "$name" "$rc" \
    "$(python3 -c "import time; print(time.time() - $t0)")" | tee -a "$out/steps.txt"
  tail -n 5 "$out/$name.log"
  [ "$rc" -eq 0 ] || failed=1
  return "$rc"
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$out/steps.txt"
step data python -m chess_vision_tpu.datagen.generate --config "$config" || exit 1
recipe=(model.pretrained=false training.batch_size=128 training.lr=0.0002
        training.epochs=4 "data.train_dir=$train_dir" "data.test_dir=$test_dir"
        "data.ood_val_dir=$ood_dir" data.num_workers=8)
step train python -m chess_vision_tpu_torch.train --config configs/vit.yaml \
  --set "${recipe[@]}" data.cache_budget_gb=24 \
        "checkpointing.save_dir=$ckpt_dir" "logging.tensorboard_dir=$out/runs" \
  || exit 1
ckpt=$ckpt_dir/best.ckpt
[ -f "$ckpt" ] || ckpt=$ckpt_dir/latest.ckpt
step evaluate python -m chess_vision_tpu_torch.evaluate --checkpoint "$ckpt" \
  --test-dir "$test_dir" --max-samples 4096 --batch-size 256
for layout in block flat fused; do
  for mode in rgb ycbcr420; do
    CHESS_VISION_INT8_LAYOUT=$layout step "int8_eval_${layout}_$mode" \
      python -m chess_vision_tpu_torch.experiments.int8_eval \
      --checkpoint "$ckpt" --test-dir "$test_dir" --max-samples 4096 \
      --calib 64 --mode "$mode"
  done
done
step int8_gate python -m chess_vision_tpu_torch.experiments.int8_gate \
  --checkpoint "$ckpt" --test-dir "$test_dir" \
  --max-samples 4096 --calib 64 --out "$out/int8_gate.json"
step smoke python3 chip_smoke.py --checkpoint "$ckpt" --images "$test_dir" \
  --keep-going
cp "$ckpt_dir/eval_results.jsonl" "$ckpt_dir/run_meta.json" "$out/" 2>/dev/null
if step train_device_cache python -m chess_vision_tpu_torch.train \
    --config configs/vit.yaml --set "${recipe[@]}" data.transport=packed \
    data.cache_decoded=false "checkpointing.save_dir=$dc_dir" \
    "logging.tensorboard_dir=$out/runs_dc"; then
  dc_ckpt=$dc_dir/best.ckpt
  [ -f "$dc_ckpt" ] || dc_ckpt=$dc_dir/latest.ckpt
  CHESS_VISION_INT8_LAYOUT=block step int8_eval_device_cache \
    python -m chess_vision_tpu_torch.experiments.int8_eval \
    --checkpoint "$dc_ckpt" --test-dir "$test_dir" --max-samples 4096 \
    --calib 64 --mode ycbcr420
fi
exit "$failed"
