#!/bin/bash
# Data-parallel training over the cards of one host through the PyTorch
# port (reference: distributed_run.sh / torchrun): one process a card,
# NCCL, --batch_size is each rank's. NPROC defaults to every visible card.
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}
torchrun --nproc_per_node "$NPROC" -m wildlifemapper_tpu_torch.cli.train \
    ${COCO_PATH:+--coco_path "$COCO_PATH"} \
    --image_root "${IMAGE_ROOT:-}" \
    --batch_size 2 --use_amp "$@"
