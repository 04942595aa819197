#!/usr/bin/env bash
# Case-switch training launcher with W&B logging, through the PyTorch port
# (reference: wildlifemapper/run_with_wandb.sh:1-134, the same cases).
#   * single_chip trains on one card (the current CUDA device;
#     CUDA_VISIBLE_DEVICES picks it);
#   * "distributed" runs scripts/distributed_run_torch.sh: torchrun, one
#     process a card, each rank loading its own shard of the data;
#   * bf16 (--use_amp) and uint8 batches normalised on the card
#     (--device_normalize) are on for every configuration.
set -e

COCO_PATH=${COCO_PATH:-./coco_annotations}
OUTPUT_DIR=${OUTPUT_DIR:-./exp/box_model}
WANDB_PROJECT=${WANDB_PROJECT:-wildlifemapper-tpu}
BATCH_SIZE=${BATCH_SIZE:-8}
NUM_WORKERS=${NUM_WORKERS:-$(nproc)}
EPOCHS=${EPOCHS:-550}

COMMON=(--coco_path "$COCO_PATH" --work_dir "$OUTPUT_DIR"
        --batch_size "$BATCH_SIZE" --num_workers "$NUM_WORKERS"
        --use_amp --device_normalize
        --use_wandb --wandb_project "$WANDB_PROJECT")

STAMP=$(date +%Y%m%d_%H%M%S)
CONFIG=${1:-single_chip}
[ $# -gt 0 ] && shift

case $CONFIG in
    single_chip)
        echo "Running single-card training with W&B logging..."
        python -m wildlifemapper_tpu_torch.cli.train "${COMMON[@]}" \
            --epochs "$EPOCHS" --run_name "single_chip_$STAMP" "$@"
        ;;

    resume)
        echo "Resuming training with W&B logging..."
        python -m wildlifemapper_tpu_torch.cli.train "${COMMON[@]}" \
            --epochs "$EPOCHS" --resume \
            --run_name "resume_training_$STAMP" "$@"
        ;;

    distributed)
        echo "Running data-parallel training over the host's cards with W&B logging..."
        # distributed_run_torch.sh reads COCO_PATH from the env and sets
        # the reference's per-process batch size (2); flags here override it.
        COCO_PATH="$COCO_PATH" \
        bash "$(dirname "$0")/distributed_run_torch.sh" \
            --work_dir "$OUTPUT_DIR" --num_workers 4 \
            --epochs "$EPOCHS" --device_normalize \
            --use_wandb --wandb_project "$WANDB_PROJECT" \
            --run_name "distributed_$STAMP" "$@"
        ;;

    debug)
        echo "Running debug training (5 epochs) with W&B logging..."
        python -m wildlifemapper_tpu_torch.cli.train "${COMMON[@]}" \
            --epochs 5 --run_name "debug_run_$STAMP" "$@"
        ;;

    high_lr)
        echo "Running training with high learning rate and W&B logging..."
        python -m wildlifemapper_tpu_torch.cli.train "${COMMON[@]}" \
            --epochs "$EPOCHS" --lr 0.0005 \
            --run_name "high_lr_experiment_$STAMP" "$@"
        ;;

    custom)
        echo "Running custom configuration with W&B logging..."
        # the reference's "custom" hyperparameters (--clip_max_norm 0.1);
        # pass other values through "$@"
        python -m wildlifemapper_tpu_torch.cli.train "${COMMON[@]}" \
            --epochs "$EPOCHS" --lr 0.0001 --weight_decay 0.001 \
            --lr_drop 40 --clip_max_norm 0.1 \
            --bbox_loss_coef 5 --giou_loss_coef 2 \
            --run_name "custom_experiment_$STAMP" "$@"
        ;;

    *)
        echo "Usage: $0 [single_chip|resume|distributed|debug|high_lr|custom] [extra train flags...]"
        echo ""
        echo "Configurations:"
        echo "  single_chip - Training on one card (default)"
        echo "  resume      - Resume training from the latest checkpoint"
        echo "  distributed - Data-parallel training over the host's cards"
        echo "  debug       - Quick debug run (5 epochs)"
        echo "  high_lr     - Experiment with higher learning rate"
        echo "  custom      - Reference 'custom' hyperparameters"
        exit 1
        ;;
esac

echo "Training completed!"
echo "Check your W&B dashboard (offline JSONL fallback: $OUTPUT_DIR/logs/)"
