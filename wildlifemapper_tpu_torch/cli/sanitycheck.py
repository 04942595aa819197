"""Data sanity-check CLI of the PyTorch port: render ground-truth overlays
of train samples; counterpart of wildlifemapper_tpu/cli/sanitycheck.py.

Behavioral parity target: the reference's (disabled) dataset sanity loop at
train.py:137-154 — iterate the *transformed* train dataset, draw the target
boxes over the image, and write ``data_sanitycheck.png``:

    python -m wildlifemapper_tpu_torch.cli.sanitycheck --synthetic_data -n 4

Draws the post-transform ground truth (resize-768, optional flip, normalized
cxcywh denormalized back to pixels), i.e. exactly what the criterion will be
fed. It runs no model, so it needs no card; drawing needs PIL, imported only
in `render_sample` (the card's own machine has none).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..train.logging import SPECIES
from .train import add_config_args, config_from_args


def render_sample(example, emit_uint8: bool):
    """GT overlay for one loader example dict (host-side numpy) as a PIL
    image; PIL imported here."""
    from PIL import Image, ImageDraw

    h, w = (int(example["size"][0]), int(example["size"][1]))
    arr = np.asarray(example["image"])[:h, :w]
    if emit_uint8:
        arr = arr.astype(np.uint8)
    else:
        from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
        arr = ((arr * IMAGENET_STD + IMAGENET_MEAN) * 255).clip(0, 255)
        arr = arr.astype(np.uint8)
    img = Image.fromarray(arr)
    d = ImageDraw.Draw(img)
    boxes = np.asarray(example["boxes"])
    labels = np.asarray(example["labels"])
    valid = np.asarray(example["valid"])
    for (cx, cy, bw, bh), lbl, ok in zip(boxes, labels, valid):
        if not ok:
            continue
        # normalized cxcywh in the post-resize (h, w) frame -> pixel xyxy
        x0, x1 = (cx - bw / 2) * w, (cx + bw / 2) * w
        y0, y1 = (cy - bh / 2) * h, (cy + bh / 2) * h
        name, color = SPECIES.get(int(lbl), ("Other", (255, 165, 0)))
        d.rectangle([x0, y0, x1, y1], outline=color, width=2)
        d.text((x0, max(y0 - 10, 0)), name, fill=color)
    return img


def main(argv=None):
    p = add_config_args(argparse.ArgumentParser(__doc__))
    p.add_argument("--split", default="train")
    p.add_argument("-n", "--num_samples", type=int, default=1)
    p.add_argument("--output", default="data_sanitycheck.png",
                   help="first sample's path; sample i>0 gets a _<i> suffix")
    # --seed comes from add_config_args; it seeds the epoch-0 augmentations.
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    from ..data.loader import DataLoader, build_dataset

    ds = build_dataset(args.split, cfg.data)
    loader = DataLoader(ds, 1, shuffle=(args.split == "train"),
                        drop_last=False)
    out = Path(args.output)
    written = []
    it = loader.epoch(args.seed)
    try:
        for i, batch in enumerate(it):
            if i >= args.num_samples:
                break
            example = {k: np.asarray(v)[0] for k, v in batch.items()
                       if k != "batch_valid"}
            img = render_sample(example, cfg.data.device_normalize)
            path = out if i == 0 else out.with_name(
                f"{out.stem}_{i}{out.suffix}")
            img.save(path)
            n_gt = int(np.asarray(example["valid"]).sum())
            print(f"wrote {path} (image_id={int(example['image_id'])}, "
                  f"{n_gt} GT boxes)")
            written.append(str(path))
    finally:
        it.close()
        loader.close()
    if not written:
        raise SystemExit(f"no samples in split '{args.split}'")
    return written


if __name__ == "__main__":
    main()
