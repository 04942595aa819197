#!/bin/bash
# HerdNet-data training on the card through the PyTorch port (reference
# analog: train_herdnet.sh), in the crop-prologue shape (768-px content,
# windows of 12); add --train_encoder to train the encoder from scratch, or
# --checkpoint to start from a .pth. Expects CSVs already converted:
#   python -m wildlifemapper_tpu_torch.data.csv_to_coco --csv_file train.csv \
#       --images_dir images/train --output_json coco_annotations/train.json
# Decoding the image files needs PIL. For ViT-L / ViT-H add e.g.
# --model_type vit_h --remat (remat keeps ViT-H's batches in device memory).
set -e
ANN=${ANN:-./coco_annotations}
IMAGES=${IMAGES:-./images}
python -m wildlifemapper_tpu_torch.cli.train \
    --coco_path "$ANN" --image_root "$IMAGES" \
    --use_amp --content_size 768 --crop_prologue --window_size 12 \
    --batch_size 8 --num_workers "$(nproc)" --worker_mode process \
    --device_normalize \
    --work_dir ./checkpoints "$@"
