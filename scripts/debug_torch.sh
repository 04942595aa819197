#!/bin/bash
# Short smoke run through the PyTorch port (reference: debug.sh /
# run_with_wandb.sh "debug": 5 epochs) on synthetic tiles.
python -m wildlifemapper_tpu_torch.cli.train \
    ${COCO_PATH:+--coco_path "$COCO_PATH"} \
    --synthetic_data --epochs 5 --batch_size 2 "$@"
