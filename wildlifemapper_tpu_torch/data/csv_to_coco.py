"""HerdNet CSV -> COCO JSON converter of the PyTorch port; counterpart of
wildlifemapper_tpu/data/csv_to_coco.py, with its names, semantics and flags.

Behavioral parity target: wildlifemapper/csv_to_coco.py — accepts point
CSVs (`images,x,y,labels`) or bbox CSVs (`images,x_min,y_min,x_max,y_max,
labels`, :56), converts points to fixed-size boxes (default 10 px; integer
half-size and clamp-at-creation, :42-47), probes image sizes with PIL
(:22-29), skips images it cannot read (:130-132), clamps boxes to
[0, dim-1] with a 1-px floor (:163-167) while keeping the PRE-clamp area
(:153,161), assigns image ids in sorted-filename order (pandas groupby
sorts keys, :107,125) and builds categories from every CSV label
(:110-119). stdlib csv instead of pandas. Extensions beyond the
reference: `x1,y1,x2,y2` accepted as bbox-header aliases, and
`default_size` substitutes a size for unprobeable images instead of
skipping them.

PIL is imported inside `probe_image_size` alone, outside its `try`: the
module imports without it, and a machine without PIL fails on the first
image with the ImportError instead of skipping every image as unreadable.

Usage:
  python -m wildlifemapper_tpu_torch.data.csv_to_coco --csv_file train.csv \
      --images_dir images/train --output_json coco_annotations/train.json
"""

from __future__ import annotations

import csv
import json
from datetime import datetime
from pathlib import Path
from typing import List, Optional, Tuple

POINT_HEADERS = {"images", "x", "y", "labels"}
# The reference's bbox header set (csv_to_coco.py:56). x1..y2 accepted as
# aliases for convenience; header match is exact-set, like the reference.
BBOX_HEADERS = {"images", "x_min", "y_min", "x_max", "y_max", "labels"}
BBOX_ALIAS_HEADERS = {"images", "x1", "y1", "x2", "y2", "labels"}


def point_to_bbox(x: float, y: float, box_size: int = 10) -> List[float]:
    """Center a fixed-size box on an annotation point (csv_to_coco.py:42-47):
    integer half-size (`bbox_size // 2`) and x/y clamped to >= 0 at
    creation; width/height stay box_size (the :163-167 clamp runs later).
    Int operands are deliberately NOT cast to float — the reference's JSON
    keeps int values where ints survive the arithmetic."""
    half = box_size // 2
    return [max(0, x - half), max(0, y - half), box_size, box_size]


def clamp_bbox(bbox: List[float], width: int, height: int) -> List[float]:
    """In-bounds clamp (csv_to_coco.py:163-167): origin to [0, dim-1],
    extent to [1, dim-origin] — degenerate boxes get a 1-px floor."""
    x0 = max(0, min(bbox[0], width - 1))
    y0 = max(0, min(bbox[1], height - 1))
    bw = max(1, min(bbox[2], width - x0))
    bh = max(1, min(bbox[3], height - y0))
    return [x0, y0, bw, bh]


def probe_image_size(path: Path) -> Optional[Tuple[int, int]]:
    """(w, h), or None if unreadable (csv_to_coco.py:22-29 returns None and
    the caller skips the image). PIL itself must be importable: its
    ImportError is raised, not taken for an unreadable image."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            return im.size
    except Exception as e:
        print(f"Warning: Could not read image {path}: {e}")
        return None


def detect_mode(headers) -> Tuple[str, Tuple[str, ...]]:
    """Exact header-set match like the reference (csv_to_coco.py:50-62);
    returns (mode, bbox column names)."""
    headers = set(headers)
    if headers == POINT_HEADERS:
        return "point", ()
    if headers == BBOX_HEADERS:
        return "bbox", ("x_min", "y_min", "x_max", "y_max")
    if headers == BBOX_ALIAS_HEADERS:
        return "bbox", ("x1", "y1", "x2", "y2")
    raise ValueError(
        f"Invalid CSV headers. Expected either:\n"
        f"  Point format: 'images,x,y,labels'\n"
        f"  Bbox format: 'images,x_min,y_min,x_max,y_max,labels'\n"
        f"  (or the x1,y1,x2,y2 aliases)\n  Got: {sorted(headers)}")


def convert_csv_to_coco(csv_file: str, images_dir: str, output_json: str,
                        box_size: int = 10,
                        default_size: Optional[tuple] = None) -> dict:
    with open(csv_file) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty csv {csv_file}")
    mode, bbox_cols = detect_mode(rows[0].keys())

    # Categories from EVERY row — including rows of images that later get
    # skipped (reference builds them from df['labels'] up front, :110-119).
    # Label VALUES keep pandas' representation for the category name
    # (int64 column -> 'class_2', float column -> 'class_2.0'/'class_2.5')
    # while ids are int-coerced like the reference's int(label).
    raw_labels = [float(r["labels"]) for r in rows]
    all_integral = all(v.is_integer() for v in raw_labels)
    unique_labels = sorted(set(int(v) if all_integral else v
                               for v in raw_labels))
    now = datetime.now()
    coco = {
        "info": {
            "description": "Wildlife dataset converted from CSV",
            "url": "", "version": "1.0", "year": now.year,
            "contributor": "CSV to COCO Converter",
            "date_created": now.isoformat(),
        },
        "licenses": [{"id": 1, "name": "Unknown License", "url": ""}],
        "images": [],
        "annotations": [],
        "categories": [{"id": int(c), "name": f"class_{c}",
                        "supercategory": "animal"} for c in unique_labels],
    }

    # Group rows by image, iterating groups in SORTED filename order —
    # pandas groupby sorts keys (:107,125) — with CSV order kept inside
    # each group.
    by_image = {}
    for row in rows:
        by_image.setdefault(row["images"], []).append(row)

    img_dir = Path(images_dir)
    image_id = 1
    annotation_id = 1
    for fname in sorted(by_image):
        size = probe_image_size(img_dir / fname)
        if size is None:
            if default_size:
                size = tuple(default_size)
            else:
                print(f"Skipping {fname} - could not read image dimensions")
                continue
        w, h = size
        coco["images"].append({
            "id": image_id, "width": w, "height": h, "file_name": fname,
            "license": 1, "flickr_url": "", "coco_url": "",
            "date_captured": "",
        })
        for row in by_image[fname]:
            if mode == "point":
                bbox = point_to_bbox(float(row["x"]), float(row["y"]),
                                     box_size)
                area = box_size * box_size
            else:
                x0c, y0c, x1c, y1c = bbox_cols
                x_min, y_min = float(row[x0c]), float(row[y0c])
                x_max, y_max = float(row[x1c]), float(row[y1c])
                bbox = [x_min, y_min, x_max - x_min, y_max - y_min]
                # area from the PRE-clamp extent (:161,174)
                area = (x_max - x_min) * (y_max - y_min)
            coco["annotations"].append({
                "id": annotation_id,
                "image_id": image_id,
                "category_id": int(float(row["labels"])),
                "bbox": clamp_bbox(bbox, w, h),
                "area": area,
                "segmentation": [],
                "iscrowd": 0,
            })
            annotation_id += 1
        image_id += 1

    out = Path(output_json)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(coco, f, indent=2)
    return coco


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--csv_file", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--output_json", required=True)
    p.add_argument("--box_size", "--bbox_size", type=int, default=10,
                   dest="box_size")
    p.add_argument("--default_width", type=int, default=None)
    p.add_argument("--default_height", type=int, default=None)
    args = p.parse_args(argv)
    if (args.default_width is None) != (args.default_height is None):
        p.error("--default_width and --default_height must be given "
                "together (a half-specified size would crash on the first "
                "unprobeable image)")
    default_size = ((args.default_width, args.default_height)
                    if args.default_width else None)
    coco = convert_csv_to_coco(args.csv_file, args.images_dir,
                               args.output_json, args.box_size, default_size)
    print(f"wrote {len(coco['images'])} images / "
          f"{len(coco['annotations'])} annotations to {args.output_json}")


if __name__ == "__main__":
    main()
