"""Minimal COCO-format dataset index (pure Python, no pycocotools); a copy
of wildlifemapper_tpu/data/coco.py.

Provides the subset of the COCO API the pipeline needs: per-image annotation
lookup and category listing, for the bundled Mara-Wildlife/HerdNet JSONs
(reference: coco_annotations/{train,val,test}.json; consumed via
torchvision.datasets.CocoDetection in dataloader_coco.py:23-48).
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Dict, List, Optional

# The port's own copy of the vendored annotation bundle (gzipped
# re-serializations of the reference's coco_annotations/*.json, byte for byte
# the JAX package's) so the package is standalone; resolve_ann_file falls
# back to it when a requested plain .json is absent.
ASSETS_DIR = Path(__file__).resolve().parent.parent / "assets" / "coco_annotations"


def resolve_ann_file(path: str) -> str:
    """Resolve an annotation path: the file itself, its .gz sibling, or the
    same-named file in the vendored assets bundle. The bundle substitution
    is LOUD — silently training on the vendored Mara-Wildlife splits when
    the user pointed at their own (mistyped/unmounted) dataset would be a
    data-correctness disaster."""
    p = Path(path)
    if p.exists():
        return str(p)
    if Path(str(p) + ".gz").exists():
        return str(p) + ".gz"
    # A directory that has OTHER split files but not this one is a
    # partially-populated user dataset (e.g. a csv_to_coco output with only
    # train.json): substituting the vendored split would score/train every
    # epoch against GT for entirely different images while the run appears
    # healthy. Hard error; the fallback is only for a fully absent dataset.
    if p.parent.is_dir():
        siblings = [q.name for q in p.parent.iterdir()
                    if q.name.endswith((".json", ".json.gz"))
                    and q.name != p.name]
        if siblings:
            raise FileNotFoundError(
                f"annotation file {path} not found, but {p.parent} contains "
                f"{siblings} — refusing to substitute the vendored bundle "
                f"for one split of a partially-present dataset. Add the "
                f"missing split or point --coco_path elsewhere.")
    for cand in (ASSETS_DIR / p.name, ASSETS_DIR / (p.name + ".gz")):
        if cand.exists():
            import warnings
            warnings.warn(
                f"annotation file {path} not found; substituting the "
                f"vendored bundle {cand} (Mara-Wildlife/HerdNet splits). "
                "If you meant your own dataset, check --coco_path.",
                RuntimeWarning, stacklevel=3)
            return str(cand)
    return str(p)  # let open() raise the natural FileNotFoundError


def load_ann_json(path: str) -> dict:
    """Resolve (incl. .gz sibling / vendored bundle) and parse a COCO
    annotation file. The one loader every script should use — plain
    `json.load(open(...))` breaks on the gzipped vendored bundle."""
    ann_file = resolve_ann_file(path)
    opener = gzip.open if ann_file.endswith(".gz") else open
    with opener(ann_file, "rt") as f:
        return json.load(f)


class CocoIndex:
    def __init__(self, ann_file: str):
        ann_file = resolve_ann_file(ann_file)
        opener = gzip.open if ann_file.endswith(".gz") else open
        with opener(ann_file, "rt") as f:
            d = json.load(f)
        self.ann_file = ann_file
        self.dataset = d
        self.images: List[dict] = d.get("images", [])
        self.categories: List[dict] = d.get("categories", [])
        self.img_by_id: Dict[int, dict] = {im["id"]: im for im in self.images}
        self.anns_by_img: Dict[int, List[dict]] = {im["id"]: [] for im in self.images}
        for ann in d.get("annotations", []):
            if ann["image_id"] in self.anns_by_img:
                self.anns_by_img[ann["image_id"]].append(ann)
        self.ids: List[int] = [im["id"] for im in self.images]

    def __len__(self):
        return len(self.ids)

    def annotations(self, image_id: int) -> List[dict]:
        return self.anns_by_img.get(image_id, [])

    def max_anns_per_image(self) -> int:
        """Densest image's annotation count — sizes the fixed `max_targets`
        so padding never drops GT (the reference trains on ragged,
        untruncated targets, dataloader_coco.py:253-270)."""
        if not self.anns_by_img:
            return 0
        return max(len(v) for v in self.anns_by_img.values())

    def image_info(self, image_id: int) -> dict:
        return self.img_by_id[image_id]

    def image_path(self, image_id: int, root: Optional[str]) -> Optional[Path]:
        if not root:
            return None
        p = Path(root) / self.img_by_id[image_id]["file_name"]
        return p if p.exists() else None
