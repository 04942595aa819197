"""Build a scaled-box annotation set for the from-scratch benchmark runs of
the PyTorch port; counterpart of scripts/build_scaled_ann.py (the same
flags, files and closing line).

The bundled Mara geometry is ~49 px animals on 5472 px frames, sub-patch
(~7 px) after the DETR resize. The reference only localizes these on top of
SAM-pretrained features; trained from scratch the loss plateaus at GIoU <= 0
on them. Scaling the boxes `--factor`x around their centers yields a
convergence-feasible benchmark set with the same images, counts, and class
balance:

  factor 4  -> ~28 px at 768-content full scale (~1.7 patches/animal)
  factor 16 -> the same ratio for the 192-content proxy
               (scripts/drift_proxy_torch.py)

Usage: python scripts/build_scaled_ann_torch.py --out ann_x4 --factor 4
"""
import argparse
import os
import sys

_here = __import__("pathlib").Path(__file__).resolve()
sys.path.insert(0, str(_here.parents[1]))
sys.path.insert(0, str(_here.parent))

from drift_proxy_torch import build_scaled_annotations  # noqa: E402

from wildlifemapper_tpu_torch.config import DataConfig  # noqa: E402
from wildlifemapper_tpu_torch.data.coco import resolve_ann_file  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=None,
                    help="annotation dir (default: the bundled set)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--factor", type=float, default=4.0)
    ap.add_argument("--n_train", type=int, default=None)
    args = ap.parse_args(argv)

    src = args.src or os.path.dirname(
        resolve_ann_file(DataConfig.coco_path + "/train.json"))
    build_scaled_annotations(src, args.out, args.factor, args.n_train)
    print(f"wrote {args.out} (factor {args.factor:g}, "
          f"n_train {args.n_train or 'all'}) from {src}")


if __name__ == "__main__":
    main()
