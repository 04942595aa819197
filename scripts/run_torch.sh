#!/bin/bash
# Training on one card with resume, through the PyTorch port
# (reference: wildlifemapper/run.sh). COCO_PATH defaults to the port's
# vendored annotation bundle; IMAGE_ROOT to none (pass --synthetic_data).
python -m wildlifemapper_tpu_torch.cli.train \
    ${COCO_PATH:+--coco_path "$COCO_PATH"} \
    --image_root "${IMAGE_ROOT:-}" \
    --work_dir checkpoints --resume --use_amp "$@"
