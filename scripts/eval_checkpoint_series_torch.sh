#!/usr/bin/env bash
# Re-score a checkpoint series the PyTorch port's trainer saved, with the
# port's standalone evaluate CLI, and print a compact per-epoch AP table;
# counterpart of scripts/eval_checkpoint_series.sh with its RUN / EPOCHS /
# BOUND / EXTRA_ARGS contract. In-training val APs can be invalidated after
# the fact (a post-processing fix changes every score); this rebuilds the
# curve from the checkpoint files on disk. Evaluates on the card unless
# EXTRA_ARGS carries --device cpu.
#
# Usage:
#   RUN=checkpoints CONFIG_JSON=checkpoints/config.json \
#     EPOCHS="9 19 29" scripts/eval_checkpoint_series_torch.sh
#
# EXTRA_ARGS defaults to the frame-fixed, device-normalized evaluation;
# override it for other configurations. CONFIG_JSON (the config.json the
# trainer wrote beside its checkpoints) gives the trained architecture.
set -u
cd "${REPO:-$(dirname "$0")/..}" || exit 1
RUN=${RUN:?set RUN=<work_dir with checkpoint_epoch_N>}
COCO=${COCO:-}
EPOCHS=${EPOCHS:-$(ls -d "$RUN"/checkpoint_epoch_* 2>/dev/null |
  sed 's/.*checkpoint_epoch_//' | sort -n | tr '\n' ' ')}
EXTRA_ARGS=${EXTRA_ARGS:---synthetic_data --device_normalize --aux_loss --fix_hw_swap}
BATCH=${BATCH:-8}
BOUND=${BOUND:-900}

for ep in $EPOCHS; do
  ckpt="$RUN/checkpoint_epoch_$ep"
  [ -e "$ckpt" ] || { echo "=== epoch $ep: MISSING ($ckpt)"; continue; }
  echo "=== epoch $ep ==="
  # shellcheck disable=SC2086
  timeout "$BOUND" python -m wildlifemapper_tpu_torch.cli.evaluate $EXTRA_ARGS \
    ${COCO:+--coco_path "$COCO"} --batch_size "$BATCH" \
    --torch_checkpoint "$ckpt" \
    ${CONFIG_JSON:+--config_json "$CONFIG_JSON"} 2>&1 |
    grep -E "^coco/(AP|AP50|AP75|AR100):" ||
    echo "epoch $ep: eval FAILED (rc=$?: the evaluation failed or timed out)"
done
echo SERIES_DONE
