#!/bin/bash
# Detections drawn over the val split with the PyTorch port (reference:
# infer.sh). CHECKPOINT is a reference .pth; pass --torch_checkpoint with a
# port checkpoint instead. Drawing needs PIL.
python -m wildlifemapper_tpu_torch.cli.visualize \
    ${COCO_PATH:+--coco_path "$COCO_PATH"} \
    --image_root "${IMAGE_ROOT:-}" \
    --checkpoint "${CHECKPOINT:?set CHECKPOINT=path/to/best_checkpoint.pth}" "$@"
